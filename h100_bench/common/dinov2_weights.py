"""Random DINOv2 ViT weights made from ``--seed``, under the public
checkpoint's names (``facebookresearch/dinov2``), on the run's device.

Drawn by one generator in a few large calls (a billion numbers take a
fraction of a second on the card) and handed the same to the program and
to the reference, as float32 tensors holding bfloat16 values: the type the
blocks are served in, so the program's cast is exact and a gap between the
two is the arithmetic's alone.  The statistics are the configuration's
``assumed``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from h100_bench.common.weights import generator


def param_specs(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, kind) of every weight; kind is ``linear`` (kernels and
    the patch embedding), ``bias``, ``token``, ``ln_scale`` or ``gamma``."""
    h, f = cfg["hidden_size"], cfg["ffn_hidden_size"]
    p, c = cfg["patch_size"], cfg["num_channels"]
    n = (cfg["image_size"] // p) ** 2
    specs = [("cls_token", (1, 1, h), "token")]
    if cfg["num_register_tokens"]:
        specs.append(("register_tokens", (1, cfg["num_register_tokens"], h), "token"))
    specs += [("pos_embed", (1, 1 + n, h), "bias"), ("patch_embed.proj.weight", (h, c, p, p), "linear"),
              ("patch_embed.proj.bias", (h,), "bias")]
    for i in range(cfg["num_hidden_layers"]):
        b = f"blocks.{i}."
        specs += [(b + "norm1.weight", (h,), "ln_scale"), (b + "norm1.bias", (h,), "bias"),
                  (b + "attn.qkv.weight", (3 * h, h), "linear"), (b + "attn.qkv.bias", (3 * h,), "bias"),
                  (b + "attn.proj.weight", (h, h), "linear"), (b + "attn.proj.bias", (h,), "bias"),
                  (b + "ls1.gamma", (h,), "gamma"),
                  (b + "norm2.weight", (h,), "ln_scale"), (b + "norm2.bias", (h,), "bias"),
                  (b + "mlp.w12.weight", (2 * f, h), "linear"), (b + "mlp.w12.bias", (2 * f,), "bias"),
                  (b + "mlp.w3.weight", (h, f), "linear"), (b + "mlp.w3.bias", (h,), "bias"),
                  (b + "ls2.gamma", (h,), "gamma")]
    specs += [("norm.weight", (h,), "ln_scale"), ("norm.bias", (h,), "bias")]
    return specs


def dinov2_weights(seed: int, device, cfg: dict) -> Dict[str, torch.Tensor]:
    """Every weight of the configuration's tower: linears, biases and
    position embeddings N(0, 0.02^2), CLS and register tokens N(0, 1),
    LayerNorm scales 1 + U(-0.1, 0.1), LayerScale gammas U(0.1, 0.5)."""
    g = generator(seed, 4, device)
    specs = param_specs(cfg)
    normal = [s for s in specs if s[2] in ("linear", "bias", "token")]
    uniform = [s for s in specs if s[2] in ("ln_scale", "gamma")]
    z = torch.randn(sum(math.prod(s) for _, s, _ in normal), generator=g, device=device)
    u = torch.rand(sum(math.prod(s) for _, s, _ in uniform), generator=g, device=device)
    out: Dict[str, torch.Tensor] = {}
    i = 0
    for name, shape, kind in normal:
        n = math.prod(shape)
        out[name] = _bf16(z[i:i + n].view(shape) * (1.0 if kind == "token" else 0.02))
        i += n
    i = 0
    for name, shape, kind in uniform:
        n = math.prod(shape)
        v = u[i:i + n].view(shape)
        out[name] = _bf16(1.0 + 0.2 * (v - 0.5) if kind == "ln_scale" else 0.1 + 0.4 * v)
        i += n
    return {name: out[name] for name, _, _ in specs}


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)
