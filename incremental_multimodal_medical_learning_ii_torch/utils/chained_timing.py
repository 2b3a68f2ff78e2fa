"""Chained device timing (counterpart of the JAX package's
``utils/chained_timing.py``): per-iteration time as the difference
between a long and a short chained run.

The workload runs K times inside one call, each iteration fed by an
accumulator that the previous one updated, so the iterations run one after
another; the difference between a long and a short run cancels the fixed
cost of a call (launch, the barrier, the host's bookkeeping).  Fresh input
buffers every repeat; the repeats interleave short and long; the minimum
over repeats is kept, because jitter only ever adds time.  The barrier
after each run is a ``torch.cuda.synchronize`` of the card the result
lies on (CPU results need none: PyTorch runs eagerly there).
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Sequence

import torch


def _barrier(result) -> None:
    if isinstance(result, torch.Tensor) and result.is_cuda:
        torch.cuda.synchronize(result.device)


def time_chained(
    loop_factory: Callable[[int], Callable],
    args_for_repeat: Callable[[int], Sequence],
    k_short: int,
    k_long: int,
    repeats: int = 3,
) -> Optional[float]:
    """Per-iteration seconds via long-minus-short chained runs.

    ``loop_factory(k)`` returns a callable running the workload k times;
    ``args_for_repeat(r)`` returns its argument tuple for repeat r (r = -1
    for the warm-up call): vary at least one buffer per repeat.

    Returns ``None`` when the long run measured no slower than the short
    one: the sample is invalid (the two runs straddled a change of the
    card's or the host's state), and callers report it as missing, never
    clamped into an absurd rate.
    """
    if repeats < 1:
        raise ValueError(f"repeats must be >= 1, got {repeats}")
    if k_long <= k_short:
        raise ValueError(f"k_long ({k_long}) must exceed k_short ({k_short})")
    loops = {}
    for k in (k_short, k_long):
        loops[k] = loop_factory(k)
        _barrier(loops[k](*args_for_repeat(-1)))  # warm-up: first calls, builds, caches
    # interleaved (short, long, short, long, ...): a change of state between
    # two blocks of runs would otherwise inflate the difference one-sidedly
    times = {k_short: float("inf"), k_long: float("inf")}
    for r in range(repeats):
        args = args_for_repeat(r)
        for k in (k_short, k_long):
            t0 = time.perf_counter()
            _barrier(loops[k](*args))
            times[k] = min(times[k], time.perf_counter() - t0)
    diff = times[k_long] - times[k_short]
    if diff <= 0:
        return None
    return diff / (k_long - k_short)


def rate_or_none(per_iter_s: Optional[float], items_per_iter: float) -> Optional[float]:
    """items/sec from a per-iteration time, propagating invalid samples."""
    if per_iter_s is None or per_iter_s <= 0:
        return None
    return items_per_iter / per_iter_s
