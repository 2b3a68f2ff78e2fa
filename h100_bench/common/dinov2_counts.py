"""Frozen operation and byte counts of the DINOv2 tower, from the
configuration's shapes (the benchmark's yardstick, as ``counts.py`` is for
the rest).  Operations are multiply-adds times two, the products alone
(what ``torch.utils.flop_counter`` counts): LayerNorm, softmax, SiLU and
the residual sums are left out."""

from __future__ import annotations

from typing import Tuple


def tokens(cfg: dict) -> int:
    """CLS, the registers and the patches: 1,374 for ViT-g/14-reg at 518²."""
    return 1 + cfg["num_register_tokens"] + (cfg["image_size"] // cfg["patch_size"]) ** 2


def block_flops(cfg: dict) -> float:
    """One block over one image: qkv, QK^T and PV, the projection, w12 and w3."""
    t, h, f = tokens(cfg), cfg["hidden_size"], cfg["ffn_hidden_size"]
    return 2.0 * t * h * (3 * h + h + 2 * f + f) + 4.0 * t * t * h


def vit_flops_per_image(cfg: dict, in_channels: int = 1) -> float:
    """One image through the tower: the patch embedding over ``in_channels``
    (the port folds the three grey planes into one) and every block."""
    p = cfg["patch_size"]
    n = (cfg["image_size"] // p) ** 2
    return 2.0 * n * in_channels * p * p * cfg["hidden_size"] + cfg["num_hidden_layers"] * block_flops(cfg)


def k3_counts(b: int, nh: int, s: int, hd: int, elem_bytes: int = 2) -> Tuple[float, float]:
    """(operations, bytes) of one K3 launch without a mask: QK^T and PV over
    every (query, key) pair; q, k, v read once and o written once."""
    return 4.0 * b * nh * s * s * hd, 4.0 * b * nh * s * hd * elem_bytes
