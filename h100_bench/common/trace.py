"""The traced run's device timeline and the benchmark's host spans.

:class:`DeviceTrace` records the card's activity with ``torch.profiler``
(CUDA activity only: recording every host op would slow the window it
measures).  The benchmark's spans are wall-clock nanoseconds
(``time.time_ns``), the clock the profiler's timestamps use, so a gap on the
card can be named by what the host was doing.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

Interval = Tuple[str, int, int]  # name, start ns, end ns


class Spans:
    """Named host intervals, kept in memory."""

    def __init__(self):
        self.items: List[Interval] = []

    def add(self, name: str, t0_ns: int, t1_ns: int) -> None:
        self.items.append((name, t0_ns, t1_ns))

    def named(self, name: str) -> List[Interval]:
        return [s for s in self.items if s[0] == name]


class DeviceTrace:
    """Context manager; ``kernels`` holds (name, start ns, end ns) of every
    kernel, copy and set the card ran while it was open."""

    def __init__(self, enabled: bool, device):
        self.enabled = enabled and getattr(device, "type", str(device)) == "cuda"
        self.kernels: List[Interval] = []
        self.t0_ns = self.t1_ns = 0
        self._prof = None

    def __enter__(self):
        self.t0_ns = time.time_ns()
        if self.enabled:
            import torch
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.synchronize()
            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.__enter__()
            self.t0_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            import torch

            torch.cuda.synchronize()
            self.t1_ns = time.time_ns()
            self._prof.__exit__(*exc)
            from torch.autograd import DeviceType

            for e in self._prof.profiler.kineto_results.events():
                if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
                    self.kernels.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
            self._prof = None
        else:
            self.t1_ns = time.time_ns()
        return False


def merged(kernels: Sequence[Interval]) -> List[Tuple[int, int]]:
    """The union of the kernels' intervals, sorted."""
    out: List[List[int]] = []
    for _, a, b in sorted(kernels, key=lambda k: k[1]):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_s(kernels: Sequence[Interval]) -> float:
    return sum(b - a for a, b in merged(kernels)) / 1e9


def device_time_s(kernels: Sequence[Interval], match) -> Tuple[float, int]:
    """(seconds, count) of the kernels whose name ``match`` accepts."""
    sel = [b - a for name, a, b in kernels if match(name)]
    return sum(sel) / 1e9, len(sel)


def kernel_table(kernels: Sequence[Interval]) -> List[Tuple[str, int, float]]:
    """(name, launches, seconds) by device time, most first."""
    tot: Dict[str, List[int]] = {}
    for name, a, b in kernels:
        t = tot.setdefault(name, [0, 0])
        t[0] += 1
        t[1] += b - a
    return sorted(((k, n, ns / 1e9) for k, (n, ns) in tot.items()), key=lambda r: -r[2])


def top_ops(kernels: Sequence[Interval], n: int = 10) -> List[list]:
    return [[name[:120], s] for name, _, s in kernel_table(kernels)[:n]]


def idle_gaps(kernels: Sequence[Interval], spans: Sequence[Interval], t0_ns: int, t1_ns: int,
              n: int = 10) -> List[list]:
    """The longest stretches with nothing on the card inside [t0, t1], each
    named by the shortest host span around its middle."""
    edges = [(t0_ns, t0_ns)] + merged(kernels) + [(t1_ns, t1_ns)]
    gaps = []
    for (_, a), (b, _) in zip(edges, edges[1:]):
        if b > a:
            gaps.append((b - a, a, b))
    gaps.sort(reverse=True)
    out = []
    for length, a, b in gaps[:n]:
        mid = (a + b) // 2
        around = [s for s in spans if s[1] <= mid <= s[2]]
        name = min(around, key=lambda s: s[2] - s[1])[0] if around else "outside the benchmark's spans"
        out.append([name, length / 1e9])
    return out


def breakdown(kernels, spans, t0_ns, t1_ns) -> Optional[dict]:
    if not kernels:
        return None
    return {"device_ops": top_ops(kernels), "idle_gaps": idle_gaps(kernels, spans, t0_ns, t1_ns)}
