"""Fused L2-normalise + cosine scoring (counterpart of the JAX package's
``ops/pallas_cosine.py``).

:func:`fused_pairwise_cosine` launches the hand-written CUDA kernel
``csrc/fused_cosine.cu`` for tensors on CUDA and takes the plain version,
:func:`pairwise_cosine` (``ops/cosine.py``), for tensors on the CPU.  The
kernel normalises both operands on chip and never writes a normalised
intermediate to device memory.  It holds at most 256 bank rows in shared
memory, so a larger bank goes in chunks of 256 rows, one launch each, into
the output's column slices (the JAX kernel takes any bank).  No-grad paths
only: it has no backward.
"""

from __future__ import annotations

import ctypes
from typing import Callable

import torch

from incremental_multimodal_medical_learning_ii_torch.ops.cosine import pairwise_cosine

DIM = 128  # the joint embedding width the kernel is built for
MAX_BANK_ROWS = 256  # shared memory holds the normalised bank (128 KB at 256 rows)

__all__ = ["fused_pairwise_cosine", "pairwise_cosine"]


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
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
    from incremental_multimodal_medical_learning_ii_torch.ops.cuda_build import load

    fn = load("fused_cosine").fused_cosine_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(x.data_ptr(), t.data_ptr(), out.data_ptr(), x.shape[0], t.shape[0], out.stride(0),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_cosine kernel launch failed: CUDA error {rc}")
    fused_pairwise_cosine.launches += 1


def fused_pairwise_cosine(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(B, 128) x (T, 128) float32 -> (B, T) float32 cosine similarities."""
    if x.device.type == "cpu" and t.device.type == "cpu":
        return pairwise_cosine(x, t)
    if x.device.type != "cuda" or t.device != x.device:
        raise ValueError(f"fused_pairwise_cosine: operands on {x.device} and {t.device}")
    if x.dim() != 2 or t.dim() != 2 or x.shape[1] != DIM or t.shape[1] != DIM:
        raise ValueError(f"expected (B, {DIM}) x (T, {DIM}), got {tuple(x.shape)} x {tuple(t.shape)}")
    if x.dtype != torch.float32 or t.dtype != torch.float32:
        raise ValueError(f"expected float32 operands, got {x.dtype} and {t.dtype}")
    out = torch.empty((x.shape[0], t.shape[0]), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    return scores_in_chunks(_aligned(x), _aligned(t), out, _launch)


fused_pairwise_cosine.launches = 0
