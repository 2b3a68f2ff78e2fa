"""PIL-parity antialiased bilinear resize, as two batched matmuls.

Counterpart of the JAX package's ``ops/resize.py``.  The reference resizes
every CXR with ``torchvision.transforms.Resize`` on a PIL image: PIL's
antialiased bilinear (triangle) filter applied separably, with uint8
rounding.  That is a pair of row/column weighting matrices, so the resize
is ``W_h @ img @ W_w^T``.  The matrices are built on the host in numpy
(``resize_matrix`` reproduces PIL's filter placement: support
``max(1, in/out)``, centres at ``(i + 0.5) * in/out``, triangle weights
normalised to sum 1); the products run in float32 with TF32 off, as the
JAX side runs them at ``Precision.HIGHEST``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def resize_matrix(in_size: int, out_size: int, padded_in: int | None = None) -> np.ndarray:
    """(out_size, padded_in) dense PIL-bilinear weight matrix."""
    padded_in = padded_in or in_size
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale  # triangle filter support
    w = np.zeros((out_size, padded_in), np.float64)
    for i in range(out_size):
        center = (i + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        taps = np.arange(xmin, xmax)
        x = (taps - center + 0.5) / filterscale
        weights = np.clip(1.0 - np.abs(x), 0.0, None)  # triangle
        ssum = weights.sum()
        if ssum > 0:
            weights = weights / ssum
        w[i, xmin:xmax] = weights
    return w.astype(np.float32)


def resize_shape_for_smaller_edge(h: int, w: int, size: int) -> Tuple[int, int]:
    """torchvision ``Resize(int)``: scale the smaller edge to ``size``; the
    long edge truncates (``int(size * long / short)``), it does not round."""
    if h <= w:
        return size, max(1, int(size * w / h))
    return max(1, int(size * h / w)), size


def apply_uint8_rounding(out: torch.Tensor) -> torch.Tensor:
    """PIL's uint8 output rounding: round half to even, then clip."""
    return torch.clamp(torch.round(out), 0.0, 255.0)


def matmul_resize(
    img: torch.Tensor, w_h: torch.Tensor, w_w: torch.Tensor, round_uint8: bool = True
) -> torch.Tensor:
    """(H, W) x (outH, H) x (outW, W) -> (outH, outW) float32, one image."""
    return batched_matmul_resize(img[None], w_h[None], w_w[None], round_uint8)[0]


def batched_matmul_resize(
    imgs: torch.Tensor, w_h: torch.Tensor, w_w: torch.Tensor, round_uint8: bool = True
) -> torch.Tensor:
    """(B, Hp, Wp) images with per-image weight matrices (B, outH, Hp),
    (B, outW, Wp) -> (B, outH, outW) float32."""
    x = imgs.to(torch.float32)
    out = torch.matmul(w_h, x)
    out = torch.matmul(out, w_w.transpose(-1, -2))
    if round_uint8:
        out = apply_uint8_rounding(out)
    return out
