"""Image tower (DINOv2): the images the program's tower encoded in the
window (its ``vit_images`` counter) times the operations an image needs
(``common/dinov2_counts.py``, from the configuration's shapes), over the
window, in percent of the card's dense bf16 peak."""

from h100_bench.common import counts, dinov2_counts


def read(run):
    n = run.counters.get("vit_images")
    if not n or run.device.type != "cuda":
        return None
    ops = n * dinov2_counts.vit_flops_per_image(run.config)
    return 100.0 * ops / run.window_s / (counts.PEAK_BF16 * run.chips)
