"""Device: the percentage of the traced window in which no kernel, copy or set
ran on the card (the profiler's timeline, averaged over the chips used)."""

from h100_bench.common.trace import busy_s


def read(run):
    if not run.kernels or run.trace_window_s <= 0:
        return None
    busy = run.counters.get("busy_s", busy_s(run.kernels))
    return 100.0 * (1.0 - busy / run.trace_window_s)
