"""Cosine-similarity primitives for the prompt scorer (counterpart of the
JAX package's ``ops/cosine.py``).

Rows of both operands are L2-normalised as ``x / max(||x||, 1e-8)`` — not
``F.normalize``, whose eps is 1e-12 and clamps the norm differently — then
multiplied in full float32 (the JAX side pins ``Precision.HIGHEST``; on
CUDA the port turns TF32 off, ``utils/device.py``).
"""

from __future__ import annotations

import torch

EPS = 1e-8


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = EPS) -> torch.Tensor:
    norm = torch.sqrt(torch.sum(torch.square(x), dim=dim, keepdim=True))
    return x / torch.clamp(norm, min=eps)


def pairwise_cosine(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(N, D) x (M, D) -> (N, M) cosine similarities."""
    return torch.matmul(l2_normalize(x), l2_normalize(y).T)


def cosine_to_banks(x: torch.Tensor, banks: torch.Tensor) -> torch.Tensor:
    """(B, D) images vs (C, P, D) per-class prompt embeddings -> (B, C, P)."""
    return torch.einsum("bd,cpd->bcp", l2_normalize(x), l2_normalize(banks))


def masked_mean(emb: torch.Tensor, count: torch.Tensor, p_axis: int = 1) -> torch.Tensor:
    """Mean over the zero-padded prompt axis given true counts:
    ``emb`` (C, P, D), ``count`` (C,)."""
    total = torch.sum(emb, dim=p_axis)
    return total / torch.clamp(count, min=1).to(emb.dtype)[:, None]
