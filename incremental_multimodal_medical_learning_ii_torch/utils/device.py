"""Device selection for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU.  Nothing
falls back: asking for CUDA on a host without it raises.  On CUDA, TF32 is
turned off for matmuls and cuDNN convolutions, because the JAX package
computes float32 at ``Precision.HIGHEST`` (cuDNN convolutions default to
TF32, which keeps about three decimal digits).

:func:`upload` and :func:`readback` move data to and from the card without
a synchronisation per tensor: uploads go through pinned memory, and a
readback of many tensors waits on the stream once, in a ``readback`` span
(``utils/profiling.py``; ``readbacks`` and ``readback_bytes`` count the
readbacks of at least one tensor and the tensors' bytes).
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from incremental_multimodal_medical_learning_ii_torch.utils.profiling import annotate, count


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means CUDA.  Raises if CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available on this host; pass device='cpu' to run "
                "the plain PyTorch path on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def upload(array, device: torch.device) -> torch.Tensor:
    """A numpy array on ``device``; to CUDA through pinned memory without
    blocking the host (an ordinary host-to-device copy synchronises)."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def readback(tree):
    """Every tensor of a nested dict / list / tuple / NamedTuple as numpy,
    with one synchronisation for all of them (CUDA tensors are copied into
    pinned memory without blocking, then the stream is waited on once)."""
    copies = []
    tensors = nbytes = 0

    def start(x):
        nonlocal tensors, nbytes
        if isinstance(x, torch.Tensor):
            tensors += 1
            nbytes += x.nbytes
            if x.is_cuda:
                dst = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                dst.copy_(x, non_blocking=True)
                copies.append(x.device)
                return dst
            return x.detach()
        if isinstance(x, dict):
            return {k: start(v) for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(start(v) for v in x))
        if isinstance(x, (list, tuple)):
            return type(x)(start(v) for v in x)
        return x

    def finish(x):
        if isinstance(x, torch.Tensor):
            return x.numpy()
        if isinstance(x, dict):
            return {k: finish(v) for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(finish(v) for v in x))
        if isinstance(x, (list, tuple)):
            return type(x)(finish(v) for v in x)
        return x

    staged = start(tree)
    if tensors:  # a tree of host values alone reads nothing back
        with annotate("readback"):
            for dev in set(copies):
                torch.cuda.current_stream(dev).synchronize()
        count("readbacks")
        count("readback_bytes", nbytes)
    return finish(staged)
