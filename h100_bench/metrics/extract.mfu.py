"""Device trunk: the images read back in the window times the operations an
image needs (the benchmark's count from the layer shapes, ``common/counts.py``),
over the window, in percent of the card's dense bf16 peak."""

from h100_bench.common import counts


def read(run):
    n = run.counters.get("images")
    if not n or run.device.type != "cuda":
        return None
    h, w = run.params["image_hw"]
    ops = n * counts.extract_flops_per_image(h, w, run.params["crop"])
    return 100.0 * ops / run.window_s / (counts.PEAK_BF16 * run.chips)
