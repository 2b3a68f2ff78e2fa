"""Kernel K1 (``csrc/fused_cosine.cu``) on the eval passes: the least time
the card could take for its launches in the traced window (bytes bind: each
rank's rows of an eval batch against the 10 prompt means, fp32) over K1's
device time."""

from h100_bench.common import counts
from h100_bench.common.trace import device_time_s


def read(run):
    t, n = device_time_s(run.kernels, lambda name: "fused_cosine_kernel" in name)
    if not n or t <= 0:
        return None
    ops, byts = counts.k1_counts(run.params["eval_batch"] // run.chips, 10)
    return 100.0 * n * counts.bound_s(ops, byts, counts.PEAK_FP32) / t
