"""Losses and label transforms (counterpart of the JAX package's
``objectives/losses.py``).

``bce_with_logits`` is ``torch.nn.BCEWithLogitsLoss`` (mean reduction) in
the JAX package's own stable form, ``max(x,0) - x*y + log1p(exp(-|x|))``,
with an element mask for padded batches and the growing class set of
MORE_LABELS.  On a data-parallel mesh each rank passes the global batch's
mask count as ``mask_sum``: the ranks' results then sum to the one masked
mean over the global batch that the JAX package takes.  ``max(x, 0)`` is ``torch.relu``, whose gradient at x = 0 is
0, as ``jax.grad`` gives for ``jnp.maximum(x, 0.0)`` there.
"""

from __future__ import annotations

from typing import Optional

import torch


def bce_with_logits(
    logits: torch.Tensor,
    labels: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    mask_sum: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean binary cross-entropy with logits over the (masked) elements;
    ``mask_sum`` replaces ``sum(mask)`` as the denominator (clamped to 1)."""
    x, y = logits, labels
    per_elem = torch.relu(x) - x * y + torch.log1p(torch.exp(-torch.abs(x)))
    if mask is None:
        return torch.mean(per_elem)
    mask = mask.to(per_elem.dtype)
    denom = torch.sum(mask) if mask_sum is None else mask_sum
    return torch.sum(per_elem * mask) / torch.clamp(denom, min=1.0)


def change_labels(labels: torch.Tensor) -> torch.Tensor:
    """{0,1} -> {-1,+1} float labels (reference ``change_values``)."""
    return torch.where(labels == 1, 1.0, -1.0).to(torch.float32)
