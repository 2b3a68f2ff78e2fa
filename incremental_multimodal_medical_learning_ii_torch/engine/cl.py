"""Continual-learning weight reset, myCL and profCL (counterpart of the JAX
package's ``engine/cl.py``).

For each parameter tensor: the elementwise |delta| from a snapshot, a
per-tensor cutoff ``min + threshold * (max - min)``, and every weight whose
delta is strictly below the cutoff goes back to its snapshot value.  A
pure function over the port's parameter dict (name -> tensor), with the
counts as device tensors (no host sync), so it runs inside the train step
(myCL, every step) or after an epoch (profCL).  It is elementwise, so the
(out, in) layout of a torch weight selects the same weights as the JAX
kernel's (in, out).  SHARED mode applies it twice (``applications=2``),
as the reference resets its one aliased module twice.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

Params = Dict[str, torch.Tensor]


def _reset_one(p: torch.Tensor, s: torch.Tensor, threshold) -> Tuple[torch.Tensor, torch.Tensor]:
    diff = torch.abs(p - s)
    lo, hi = torch.min(diff), torch.max(diff)
    cutoff = lo + threshold * (hi - lo)
    mask = diff < cutoff
    return torch.where(mask, s, p), torch.sum(mask, dtype=torch.int32)


def weight_reset(
    params: Params,
    snapshot: Params,
    threshold,
    applications: int = 1,
) -> Tuple[Params, torch.Tensor, torch.Tensor]:
    """Reset low-|delta| weights to the snapshot; return (params, n_reset,
    n_updated), the counts int32 and summed over tensors and applications."""
    device = next(iter(params.values())).device
    n_reset = torch.zeros((), dtype=torch.int32, device=device)
    n_total = 0
    for _ in range(applications):
        new = {}
        for name, p in params.items():
            new[name], k = _reset_one(p, snapshot[name], threshold)
            n_reset = n_reset + k
            n_total += p.numel()
        params = new
    return params, n_reset, n_total - n_reset
