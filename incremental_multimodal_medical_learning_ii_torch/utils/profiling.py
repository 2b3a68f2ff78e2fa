"""Profiling hooks (counterpart of the JAX package's ``utils/profiling.py``).

The reference has no tracing at all; here every long-running pass can
capture a ``torch.profiler`` trace, the host's ops and, when the run is on
CUDA, the card's kernels and copies.  The trace is a Chrome trace file
named ``*.pt.trace.json`` in ``trace_dir``: Perfetto (ui.perfetto.dev) and
``chrome://tracing`` open it, and TensorBoard's PyTorch profiler plugin
reads the directory.  :func:`annotate` marks a named span on the host's
timeline (and, on CUDA, over the kernels launched inside it).
"""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Iterator, Optional, Union

import torch


@contextlib.contextmanager
def maybe_trace(trace_dir: Optional[Union[str, Path]],
                device: Optional[Union[str, torch.device]] = None) -> Iterator[None]:
    """Capture a trace into ``trace_dir`` when given, else nothing.

    ``device`` is the run's: CUDA activity is recorded beside the host's
    when it is a CUDA device (``None``: when CUDA is available)."""
    if trace_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    cuda = (torch.cuda.is_available() if device is None
            else torch.device(device).type == "cuda")
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    Path(trace_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(trace_dir))):
        yield


def annotate(name: str):
    """Named span visible in the trace timeline."""
    return torch.profiler.record_function(name)
