"""Profiling hooks (counterpart of the JAX package's ``utils/profiling.py``).

The reference has no tracing at all; here every long-running pass can
capture a ``torch.profiler`` trace, the host's ops and, when the run is on
CUDA, the card's kernels and copies.  The trace is a Chrome trace file
named ``*.pt.trace.json`` in ``trace_dir``: Perfetto (ui.perfetto.dev) and
``chrome://tracing`` open it, and TensorBoard's PyTorch profiler plugin
reads the directory.

:func:`annotate` marks a named span where the program does its work, and
:func:`count` adds to a named counter.  While nothing listens, a span is a
check of two flags and a counter a check of one.  A span reaches a
profiler trace (as ``record_function``) while a ``torch.profiler`` is on,
and a :class:`Recorder` while :func:`recording` is open: the recorder
keeps each span's name, start and end (``time.time_ns()``, the clock of
the profiler's kineto timestamps, so host spans and device kernels lie on
one timeline, as do the spans of several processes on one host), its id,
its parent's id (the innermost span open in the same thread), the
thread's id and the span's attributes, plus a ``gc`` span for each
collection of Python's garbage collector.
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import threading
import time
from pathlib import Path
from typing import Dict, Iterator, List, NamedTuple, Optional, Union

import torch
import torch.autograd.profiler as _torch_profiler


class Span(NamedTuple):
    name: str
    t0_ns: int
    t1_ns: int
    span_id: int
    parent_id: Optional[int]  # None: outermost in its thread
    thread_id: int
    attrs: dict


class Recorder:
    """The spans and counters recorded while :func:`recording` is open."""

    def __init__(self):
        self.spans: List[Span] = []
        self.counters: Dict[str, int] = {}
        self._ids = itertools.count(1)
        self._local = threading.local()  # each thread's stack of open span ids
        self._lock = threading.RLock()  # re-entered when a collection starts inside count()
        self._gc_start = (0, None)  # the running collection's start ns and parent id

    def stack(self) -> List[int]:
        s = getattr(self._local, "stack", None)
        if s is None:
            s = self._local.stack = []
        return s

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]

    def on_gc(self, phase: str, info: dict) -> None:
        """A ``gc.callbacks`` hook: one ``gc`` span a collection (collections
        do not overlap: the collector runs one at a time)."""
        if phase == "start":
            stack = self.stack()
            self._gc_start = (time.time_ns(), stack[-1] if stack else None)
            return
        gen = info["generation"]
        t0, parent = self._gc_start
        self.spans.append(Span("gc", t0, time.time_ns(), next(self._ids), parent,
                               threading.get_ident(),
                               {"generation": gen, "collected": info["collected"]}))
        self.count(f"gc_collections_gen{gen}")


_active: Optional[Recorder] = None


class _Span:
    """A span open in a recorder, a profiler trace, or both."""

    __slots__ = ("rec", "name", "attrs", "t0", "span_id", "parent", "fn", "kept")

    def __init__(self, rec: Optional[Recorder], name: str, attrs: dict):
        self.rec, self.name, self.attrs = rec, name, attrs
        self.fn = None
        self.kept = True

    def __enter__(self):
        if _torch_profiler._is_profiler_enabled:
            self.fn = torch.profiler.record_function(self.name)
            self.fn.__enter__()
        rec = self.rec
        if rec is not None:
            stack = rec.stack()
            self.parent = stack[-1] if stack else None
            self.span_id = next(rec._ids)
            stack.append(self.span_id)
            self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if rec is not None:
            t1 = time.time_ns()
            rec.stack().pop()
            if self.kept:
                rec.spans.append(Span(self.name, self.t0, t1, self.span_id, self.parent,
                                      threading.get_ident(), self.attrs))
        if self.fn is not None:
            self.fn.__exit__(*exc)
        return False

    def drop(self) -> None:
        """Record nothing for this span (it turned out to cover no work)."""
        self.kept = False


class _Off:
    """What :func:`annotate` returns while nothing listens."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def drop(self) -> None:
        pass


_OFF = _Off()


def annotate(name: str, **attrs):
    """A named span: ``with annotate("train-step"): ...``.  The context's
    value has ``drop()``, which keeps the span out of the recorder."""
    rec = _active
    if rec is None and not _torch_profiler._is_profiler_enabled:
        return _OFF
    return _Span(rec, name, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the open recorder's counter ``name`` (no recorder: nothing)."""
    rec = _active
    if rec is not None:
        rec.count(name, n)


@contextlib.contextmanager
def recording() -> Iterator[Recorder]:
    """Record the program's spans and counters, and the garbage collector's
    collections (``gc`` spans, ``gc_collections_gen{0,1,2}``), until the
    block ends; one recording at a time in a process."""
    global _active
    if _active is not None:
        raise RuntimeError("a recording is already open in this process")
    rec = Recorder()
    hook = rec.on_gc
    _active = rec
    gc.callbacks.append(hook)
    try:
        yield rec
    finally:
        gc.callbacks.remove(hook)
        _active = None


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
