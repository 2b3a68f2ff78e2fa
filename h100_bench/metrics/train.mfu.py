"""The whole run: the operations of the rows trained and scored (the
adapters' forward and backward, the scoring; ``common/counts.py``) in the
window's completed runs, over the window, in percent of the fp32 peak
(TF32 off) of the chips used."""

from h100_bench.common import counts


def read(run):
    runs = run.counters.get("runs")
    if not runs or run.device.type != "cuda":
        return None
    ops = runs * counts.joint_run_flops(run.params)
    return 100.0 * ops / run.window_s / (counts.PEAK_FP32 * run.chips)
