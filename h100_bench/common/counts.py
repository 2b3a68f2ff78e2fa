"""Frozen operation and byte counts of the measured work, and the card's peaks.

These are the benchmark's own yardstick: a later change to a kernel or a
model changes the time it takes, never what these functions count.
Operations are multiply-adds times two, from the layer shapes; bytes count
each input read once and each output written once.
"""

from __future__ import annotations

from typing import Dict, Tuple

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12  # outside the tensor cores: fp32 with TF32 off
PEAK_HBM = 3.35e12  # bytes/s

RESNET50 = ((3, 64), (4, 128), (6, 256), (3, 512))
JOINT = 128


def _conv(h: int, w: int, cin: int, cout: int, k: int) -> float:
    return 2.0 * h * w * cin * cout * k * k


def resize_flops(h: int, w: int, crop: int) -> float:
    """The device preprocess: (crop, H) @ (H, W), then (crop, W) @ (W, crop)."""
    return 2.0 * crop * h * w + 2.0 * crop * w * crop


def biovil_image_flops(crop: int = 512, in_channels: int = 1) -> float:
    """One image through the ResNet-50 trunk (stride on the 3x3 conv) and the
    1x1 projector at ``crop`` x ``crop``, the stem over ``in_channels``
    (the port folds the three identical grey planes into one)."""
    s = crop // 2
    total = _conv(s, s, in_channels, 64, 7)
    s //= 2  # max pool
    cin = 64
    for li, (blocks, width) in enumerate(RESNET50):
        for bi in range(blocks):
            stride = 2 if (bi == 0 and li > 0) else 1
            so = s // stride
            total += _conv(s, s, cin, width, 1) + _conv(so, so, width, width, 3)
            total += _conv(so, so, width, 4 * width, 1)
            if bi == 0:
                total += _conv(so, so, cin, 4 * width, 1)
            cin, s = 4 * width, so
    total += _conv(s, s, 2048, JOINT, 1) + _conv(s, s, JOINT, JOINT, 1)
    return total


def extract_flops_per_image(h: int, w: int, crop: int = 512) -> float:
    """What extraction computes for one image: the resize and the network."""
    return resize_flops(h, w, crop) + biovil_image_flops(crop)


def k1_counts(b: int, t: int, d: int = JOINT) -> Tuple[float, float]:
    """(operations, bytes) of K1: both operands L2-normalised, (B, D) x (T, D)^T, fp32."""
    ops = 2.0 * b * t * d + 3.0 * (b + t) * d
    return ops, 4.0 * (b * d + t * d + b * t)


def bound_s(ops: float, byts: float, peak_ops: float) -> float:
    """The least time the card could take: operations or bytes, whichever binds."""
    return max(ops / peak_ops, byts / PEAK_HBM)


def adapter_flops(rows: int, hidden: int = 256, d: int = JOINT) -> float:
    """An MLP adapter's forward over ``rows`` rows: d -> hidden -> d."""
    return 2.0 * rows * (d * hidden + hidden * d)


def joint_run_flops(p: Dict, classes: int = 5, prompts: int = 4) -> float:
    """One joint run of the adapter experiment, the rows it trains and scores:
    per train row the image adapter's forward and backward (3x the forward)
    and the cosine to 2C prompt means; per step the text adapter over the
    bank, forward and backward; per eval row the forward and K1's cosine, per
    eval batch the text adapter over the bank."""
    bank_rows = 2 * classes * prompts
    score = 2.0 * 2 * classes * JOINT
    train_rows, epochs = p["rows"][0], p["epochs"]
    steps = -(-train_rows // p["batch"])
    per_epoch = 3 * (adapter_flops(train_rows) + train_rows * score) + 3 * steps * adapter_flops(bank_rows)
    eval_rows = sum(p["rows"][1:])
    eval_batches = sum(-(-n // p["eval_batch"]) for n in p["rows"][1:])
    per_epoch += adapter_flops(eval_rows) + eval_rows * score + eval_batches * adapter_flops(bank_rows)
    return epochs * per_epoch
