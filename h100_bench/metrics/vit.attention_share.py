"""Kernels: K3's device time (the DINOv2 tower's attention) in percent of
the device time of every kernel, copy and set in the traced window: whether
attention or the GEMMs set the tower's pace."""

from h100_bench.common.trace import device_time_s


def read(run):
    t, n = device_time_s(run.kernels, lambda name: "flash_fwd_bf16_kernel" in name)
    total, _ = device_time_s(run.kernels, lambda name: True)
    if not n or total <= 0:
        return None
    return 100.0 * t / total
