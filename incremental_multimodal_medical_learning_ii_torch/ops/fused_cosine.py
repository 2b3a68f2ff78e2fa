"""Fused L2-normalise + cosine scoring (counterpart of the JAX package's
``ops/pallas_cosine.py``).

:func:`fused_pairwise_cosine` launches the hand-written CUDA kernel
``csrc/fused_cosine.cu`` for tensors on CUDA and takes the plain version,
:func:`pairwise_cosine` (``ops/cosine.py``), for tensors on the CPU.  The
kernel normalises both operands on chip and never writes a normalised
intermediate to device memory.  It holds at most 256 bank rows in shared
memory, so a larger bank goes in chunks of 256 rows, one launch each, into
the output's column slices (the JAX kernel takes any bank).

:func:`pairwise_cosine_sharded` is the mesh variant (the JAX
``pallas_pairwise_cosine_sharded``): each rank scores its shard of the
rows against the replicated bank, through the same kernel on CUDA, and the
shards are gathered back to the global (B, T) scores in row order.

No-grad paths only: the kernel has no backward.  As ``jax.grad`` through
the Pallas kernel fails, the wrapper raises, on every device, when grad
mode is on and an operand requires grad, instead of returning a result
cut from the autograd graph.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional

import torch

from incremental_multimodal_medical_learning_ii_torch.ops.cosine import pairwise_cosine
from incremental_multimodal_medical_learning_ii_torch.ops.cuda_build import current_stream, launcher
from incremental_multimodal_medical_learning_ii_torch.parallel.mesh import Mesh, gather_rows

DIM = 128  # the joint embedding width the kernel is built for
MAX_BANK_ROWS = 256  # shared memory holds the normalised bank (128 KB at 256 rows)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]

__all__ = ["fused_pairwise_cosine", "pairwise_cosine", "pairwise_cosine_sharded"]


def _aligned(t: torch.Tensor) -> torch.Tensor:
    if not t.is_contiguous():
        return t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def scores_in_chunks(x: torch.Tensor, t: torch.Tensor, out: torch.Tensor,
                     launch: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], None]) -> torch.Tensor:
    """Fill ``out`` (B, T) chunk by chunk: ``launch(x, bank_rows, out_cols)``
    for each run of at most ``MAX_BANK_ROWS`` bank rows and its column slice."""
    for start in range(0, t.shape[0], MAX_BANK_ROWS):
        stop = min(start + MAX_BANK_ROWS, t.shape[0])
        launch(x, t[start:stop], out[:, start:stop])
    return out


def _launch(x: torch.Tensor, t: torch.Tensor, out: torch.Tensor) -> None:
    """One kernel launch: ``out`` is a column slice of a row-major (B, T) buffer."""
    fn = launcher("fused_cosine", "fused_cosine_launch", _ARGTYPES)
    rc = fn(x.data_ptr(), t.data_ptr(), out.data_ptr(), x.size(0), t.size(0), out.stride(0),
            current_stream(x))
    if rc != 0:
        raise RuntimeError(f"fused_cosine kernel launch failed: CUDA error {rc}")
    fused_pairwise_cosine.launches += 1


def fused_pairwise_cosine(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(B, 128) x (T, 128) float32 -> (B, T) float32 cosine similarities."""
    if torch.is_grad_enabled() and (x.requires_grad or t.requires_grad):
        raise RuntimeError("fused_pairwise_cosine has no backward: score under torch.no_grad(), "
                           "or use ops.cosine.pairwise_cosine where gradients must flow")
    if not (x.is_cuda and t.is_cuda and t.get_device() == x.get_device()):
        if x.device.type == "cpu" and t.device.type == "cpu":
            return pairwise_cosine(x, t)
        raise ValueError(f"fused_pairwise_cosine: operands on {x.device} and {t.device}")
    # the host's work per call is K1's latency at the serving batch: few
    # tensor calls between here and the launch
    if x.dim() != 2 or t.dim() != 2 or x.dtype != torch.float32 or t.dtype != torch.float32:
        raise ValueError(f"expected float32 (B, {DIM}) x (T, {DIM}), got {x.dtype} "
                         f"{tuple(x.shape)} x {t.dtype} {tuple(t.shape)}")
    (b, dx), (n, dt) = x.shape, t.shape
    if dx != DIM or dt != DIM:
        raise ValueError(f"expected (B, {DIM}) x (T, {DIM}), got {tuple(x.shape)} x {tuple(t.shape)}")
    out = x.new_empty((b, n))
    if b == 0 or n == 0:
        return out
    x, t = _aligned(x), _aligned(t)
    if n <= MAX_BANK_ROWS:  # one launch: no column views to build
        _launch(x, t, out)
        return out
    return scores_in_chunks(x, t, out, _launch)


fused_pairwise_cosine.launches = 0


def pairwise_cosine_sharded(mesh: Mesh, x_local: torch.Tensor, t: torch.Tensor,
                            rows: Optional[int] = None) -> torch.Tensor:
    """K1 on this rank's rows of a ``rows``-row batch (default ``size``
    shards of ``x_local``'s length; see ``parallel/mesh.py::batch_rows``)
    against the replicated bank ``t``, gathered: the global (rows, T)
    scores on every rank.  On CUDA tensors the kernel runs or this raises;
    CPU tensors take the plain version.  ``calls`` counts the calls that
    ran the kernel (its launches are K1's own count: one per 256 bank
    rows)."""
    local = fused_pairwise_cosine(x_local, t)
    if x_local.is_cuda and local.numel():
        pairwise_cosine_sharded.calls += 1
    return gather_rows(mesh, local, x_local.shape[0] * mesh.size if rows is None else rows)


pairwise_cosine_sharded.calls = 0
