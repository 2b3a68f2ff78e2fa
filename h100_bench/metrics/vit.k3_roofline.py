"""Kernel K3 (``csrc/flash_attention.cu``) in the DINOv2 tower: the least
time the card could take for its launches in the traced window (each at
(batch, heads, tokens, head width), no mask: operations at the bf16 peak
or q, k, v and o at the HBM rate, whichever binds) over K3's device time.
Null where the traced launches disagree with the program's
``vit_attention_launches``."""

from h100_bench.common import counts, dinov2_counts
from h100_bench.common.trace import device_time_s


def read(run):
    t, n = device_time_s(run.kernels, lambda name: "flash_fwd_bf16_kernel" in name)
    if not n or t <= 0 or n != run.counters.get("vit_attention_launches"):
        return None
    c = run.config
    ops, byts = dinov2_counts.k3_counts(run.params["batch"], c["num_attention_heads"],
                                        dinov2_counts.tokens(c), c["head_dim"])
    return 100.0 * n * counts.bound_s(ops, byts, counts.PEAK_BF16) / t
