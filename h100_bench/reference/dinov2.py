"""Plain DINOv2 ViT forward with registers, in float32 with TF32 off, on
raw uint8 images: the benchmark's copy of ``tests/plain_dinov2.py``.

Written from the published description (Oquab et al., arXiv 2304.07193;
Darcet et al., arXiv 2309.16588; ``facebookresearch/dinov2``'s
``DinoVisionTransformer`` with ``SwiGLUFFNFused``): the preprocess of
``reference/biovil.py`` (shortest edge to ``size`` with PIL's
antialiased bilinear, a centre crop, /255, the plane copied to three
channels) -> ImageNet's per-channel mean and std -> a 14/14 patch
convolution -> [CLS + pos0 ; registers ; patches + pos] -> blocks x =
x + g1 * Proj(softmax(QK^T / 8) V) of LN1(x), then x + g2 * W3(SiLU(a) *
b), [a, b] = W12 LN2(x) -> LN_f -> [CLS ; mean of the patch tokens].  The
one departure from DINOv2's pipeline is its bicubic resize, which this
shares with the program.  The weights come as a dict under the checkpoint's
names; nothing here reads a table the program built.

``quant="fp8"`` rounds each block's output, the residual stream, to
float8_e4m3 (one scale a tensor): the control, a precision below the
configuration's bf16.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from h100_bench.reference.biovil import _fp8, preprocess, rel_gap  # noqa: F401  (rel_gap: the check's)


def normalize(x: torch.Tensor, cfg: dict) -> torch.Tensor:
    mean = torch.tensor(cfg["image_mean"], dtype=x.dtype, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(cfg["image_std"], dtype=x.dtype, device=x.device).view(1, 3, 1, 1)
    return (x - mean) / std


def forward(w: Dict[str, torch.Tensor], x: torch.Tensor, cfg: dict, quant: Optional[str] = None) -> torch.Tensor:
    """(B, 3, S, S) normalised images -> (B, 2H) embeddings in x's type."""
    b = x.shape[0]
    p, h, heads = cfg["patch_size"], cfg["hidden_size"], cfg["num_attention_heads"]
    regs, eps = cfg["num_register_tokens"], cfg["layer_norm_eps"]
    hd = h // heads
    t = F.conv2d(x, w["patch_embed.proj.weight"], w["patch_embed.proj.bias"], stride=p)
    t = torch.cat([w["cls_token"].expand(b, -1, -1), t.flatten(2).transpose(1, 2)], dim=1) + w["pos_embed"]
    if regs:
        t = torch.cat([t[:, :1], w["register_tokens"].expand(b, -1, -1), t[:, 1:]], dim=1)
    n = t.shape[1]
    for i in range(cfg["num_hidden_layers"]):
        pre = f"blocks.{i}."

        def lin(name, u):
            return F.linear(u, w[pre + name + ".weight"], w[pre + name + ".bias"])

        def ln(name, u):
            return F.layer_norm(u, (h,), w[pre + name + ".weight"], w[pre + name + ".bias"], eps)

        qkv = lin("attn.qkv", ln("norm1", t)).reshape(b, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
        attn = torch.softmax(qkv[0] @ qkv[1].transpose(-1, -2) / math.sqrt(hd), dim=-1)
        t = t + w[pre + "ls1.gamma"] * lin("attn.proj", (attn @ qkv[2]).transpose(1, 2).reshape(b, n, h))
        a, g = lin("mlp.w12", ln("norm2", t)).chunk(2, dim=-1)
        t = t + w[pre + "ls2.gamma"] * lin("mlp.w3", F.silu(a) * g)
        if quant == "fp8":
            t = _fp8(t)
    z = F.layer_norm(t, (h,), w["norm.weight"], w["norm.bias"], eps)
    return torch.cat([z[:, 0], z[:, 1 + regs:].mean(dim=1)], dim=1)


def embed_images(weights, images: List[np.ndarray], cfg: dict, size: int, crop: int, device,
                 quant: Optional[str] = None, block: int = 8) -> torch.Tensor:
    """Embeddings of raw uint8 images, float32 with TF32 off, ``block`` images at a time."""
    w = {k: v.to(device=device, dtype=torch.float32) for k, v in weights.items()}
    out = []
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            for i in range(0, len(images), block):
                x = normalize(preprocess(images[i:i + block], size, crop, device), cfg)
                out.append(forward(w, x, cfg, quant))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    return torch.cat(out)
