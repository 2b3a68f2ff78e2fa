"""Plain DINOv2 ViT forward with registers, in float32, for the tests.

Written from the published description (Oquab et al., arXiv 2304.07193;
Darcet et al., arXiv 2309.16588; ``facebookresearch/dinov2``'s
``DinoVisionTransformer`` with ``SwiGLUFFNFused`` or ``Mlp``), in plain
``torch``: no kernel, no fold, no batching, nothing imported from the port
or from JAX.  The weights are a dict under the public checkpoint's names.

Input: (B, 3, S, S) images already normalised with ImageNet's mean and std
(the caller's transform; DINOv2's resizes bicubic, the port's bilinear:
the one departure, and it is the caller's).  Output: [CLS ; mean of the
patch tokens] after the final LayerNorm, 2H wide, the registers left out
of the mean (Hugging Face's ``Dinov2ForImageClassification`` input).
No departure from the published forward.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def forward(w: Dict[str, torch.Tensor], x: torch.Tensor, *, depth: int, heads: int,
            registers: int, ffn: str, eps: float = 1e-6) -> torch.Tensor:
    """(B, 3, S, S) normalised images -> (B, 2H) float32 embeddings."""
    w = {k: v.to(torch.float32) for k, v in w.items()}
    x = x.to(torch.float32)
    b = x.shape[0]
    p = w["patch_embed.proj.weight"].shape[-1]
    t = F.conv2d(x, w["patch_embed.proj.weight"], w["patch_embed.proj.bias"], stride=p)
    t = t.flatten(2).transpose(1, 2)  # (B, N, H), patches in row-major order
    h = t.shape[-1]
    cls = w["cls_token"].expand(b, -1, -1)
    t = torch.cat([cls, t], dim=1) + w["pos_embed"]
    if registers:
        t = torch.cat([t[:, :1], w["register_tokens"].expand(b, -1, -1), t[:, 1:]], dim=1)
    hd = h // heads
    for i in range(depth):
        pre = f"blocks.{i}."

        def lin(name, u):
            return u @ w[pre + name + ".weight"].T + w[pre + name + ".bias"]

        def ln(name, u):
            return F.layer_norm(u, (h,), w[pre + name + ".weight"], w[pre + name + ".bias"], eps)

        n = t.shape[1]
        qkv = lin("attn.qkv", ln("norm1", t)).reshape(b, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd), dim=-1)
        ctx = (attn @ v).transpose(1, 2).reshape(b, n, h)
        t = t + w[pre + "ls1.gamma"] * lin("attn.proj", ctx)
        u = ln("norm2", t)
        if ffn == "swiglu":
            a, g = lin("mlp.w12", u).chunk(2, dim=-1)
            y = lin("mlp.w3", F.silu(a) * g)
        else:
            y = lin("mlp.fc2", F.gelu(lin("mlp.fc1", u)))
        t = t + w[pre + "ls2.gamma"] * y
    z = F.layer_norm(t, (h,), w["norm.weight"], w["norm.bias"], eps)
    return torch.cat([z[:, 0], z[:, 1 + registers:].mean(dim=1)], dim=1)


def normalize(pixels: torch.Tensor) -> torch.Tensor:
    """(B, S, S) grey pixels in [0, 1] -> (B, 3, S, S): the plane copied to
    three channels, then ImageNet's per-channel normalisation."""
    mean = torch.tensor((0.485, 0.456, 0.406)).view(1, 3, 1, 1)
    std = torch.tensor((0.229, 0.224, 0.225)).view(1, 3, 1, 1)
    return (pixels.to(torch.float32)[:, None].expand(-1, 3, -1, -1) - mean) / std
