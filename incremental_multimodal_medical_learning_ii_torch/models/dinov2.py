"""DINOv2 ViT image tower with registers: the extraction path's second image
tower, beside BioViL's ResNet-50.

Sources: Oquab et al., "DINOv2: Learning Robust Visual Features without
Supervision" (arXiv 2304.07193); Darcet et al., "Vision Transformers Need
Registers" (arXiv 2309.16588); the ``dinov2_vitg14_reg`` checkpoint of
``facebookresearch/dinov2``, whose parameter names the modules here keep.
RAD-DINO (arXiv 2401.10815) is the same block at ViT-B width with a GELU
MLP and no registers: ``Dinov2Dims(ffn="mlp", ...)``.

The layer equations, for tokens x of width H:

* tokens: x0 = [cls + pos0 ; r1..rR ; P·patch + bP + pos1..N] (the
  registers get no position embedding);
* attention branch: h = x + g1 * Proj(MHA(LN1(x))), softmax(QK^T / sqrt(hd))
  over every token, no mask;
* feed-forward branch: [a, b] = W12·LN2(h) + c12, then x' = h + g2 *
  (W3·(SiLU(a) * b) + c3) (``ffn="swiglu"``), or x' = h + g2 *
  fc2(GELU(fc1(LN2(h)))) (``ffn="mlp"``);
* output: z = LN_f(x_depth); the embedding is [z_cls ; mean of the N patch
  rows of z] (2H wide; the registers are left out of the mean), the input
  of Hugging Face's ``Dinov2ForImageClassification`` head.

:func:`dinov2_forward` takes (B, S, S, C) pixels in [0, 1], as the
extraction path's device preprocess gives them (shortest edge to the
size, a centre crop, /255).  DINOv2's transform resizes bicubic; the port
resizes with its PIL-parity bilinear matrices (``ops/preprocess.py``),
the one departure from the published pipeline.  Three identical grey
planes are normalised with ImageNet's mean and std inside the forward;
:func:`fold_grayscale_patch_embed` folds that normalisation and the three
planes into a one-channel patch kernel and bias, exactly in fp32.

Precision: the patch embedding (0.02% of the operations) and the tokens'
assembly run in fp32, so the folded bias, which carries the
normalisation's mean, is not rounded; then the residual stream is held in
``dtype`` (in bf16 each block's two branch outputs are added to a bf16
stream, where DINOv2 under autocast keeps the stream in fp32: most of the
bf16 tower's gap to the fp32 reference) and every block's GEMMs run in
``dtype`` through ``F.linear`` (fp32 accumulation), LayerNorm's
statistics in fp32 (PyTorch's kernels accumulate a bf16 input's moments
in fp32), attention through K3 (``ops/flash_attention.py``: the CUDA
kernel on the card, the plain version on the CPU) with one segment for
every token, and the pooled output in fp32.  :func:`cast_dinov2_blocks`
casts the frozen blocks to ``dtype`` once, so the forward casts no
weight.  There is no int8 form of this tower.

Tracing (``utils/profiling.py``): a ``vit-encode`` span around each
forward; counters ``vit_images``, ``vit_tokens`` (images x tokens) and
``vit_attention_launches`` (one an attention call, ``depth`` a forward).
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from incremental_multimodal_medical_learning_ii_torch.ops.flash_attention import flash_attention
from incremental_multimodal_medical_learning_ii_torch.utils.profiling import annotate, count

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
FFN_KINDS = ("swiglu", "mlp")


@dataclasses.dataclass(frozen=True)
class Dinov2Dims:
    """The tower's widths; the defaults are ViT-g/14 with 4 registers at 518²."""

    hidden_size: int = 1536
    depth: int = 40
    num_heads: int = 24
    patch_size: int = 14
    image_size: int = 518
    ffn: str = "swiglu"
    ffn_hidden: int = 4096  # SwiGLU: a and b each this wide (w12 is twice it)
    num_registers: int = 4
    ln_eps: float = 1e-6

    def __post_init__(self):
        if self.ffn not in FFN_KINDS:
            raise ValueError(f"ffn {self.ffn!r} not in {FFN_KINDS}")
        if self.hidden_size % self.num_heads:
            raise ValueError(f"hidden {self.hidden_size} does not split into {self.num_heads} heads")
        if self.image_size % self.patch_size:
            raise ValueError(f"image {self.image_size} is not a whole number of {self.patch_size} patches")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid

    @property
    def num_tokens(self) -> int:
        """CLS, the registers and the patches: 1,374 for ViT-g/14-reg at 518²."""
        return 1 + self.num_registers + self.num_patches

    @property
    def embed_dim(self) -> int:
        """The pooled embedding's width: [CLS ; patch mean]."""
        return 2 * self.hidden_size


def dinov2_vitg14_reg() -> Dinov2Dims:
    """``dinov2_vitg14_reg`` at its published widths: 1,536 hidden, 40 blocks,
    24 heads of 64, patch 14 at 518², SwiGLU 4,096, 4 registers, LayerNorm eps 1e-6."""
    return Dinov2Dims()


def tiny_dinov2_dims(**kw) -> Dinov2Dims:
    """A small tower for the CPU tests: 2 blocks of 128 wide, 2 heads of 64,
    a 4 x 4 grid of 14-pixel patches (56²), SwiGLU 96, 4 registers."""
    defaults = dict(hidden_size=128, depth=2, num_heads=2, patch_size=14, image_size=56,
                    ffn="swiglu", ffn_hidden=96, num_registers=4)
    defaults.update(kw)
    return Dinov2Dims(**defaults)


def _frozen(*shape) -> nn.Parameter:
    return nn.Parameter(torch.zeros(*shape), requires_grad=False)


class PatchEmbed(nn.Module):
    def __init__(self, dims: Dinov2Dims, in_channels: int = 3):
        super().__init__()
        p = dims.patch_size
        self.proj = nn.Conv2d(in_channels, dims.hidden_size, p, stride=p)
        self.proj.requires_grad_(False)


class Attention(nn.Module):
    def __init__(self, dims: Dinov2Dims):
        super().__init__()
        h = dims.hidden_size
        self.qkv = nn.Linear(h, 3 * h)
        self.proj = nn.Linear(h, h)


class LayerScale(nn.Module):
    def __init__(self, dims: Dinov2Dims):
        super().__init__()
        self.gamma = _frozen(dims.hidden_size)


class SwiGLU(nn.Module):
    def __init__(self, dims: Dinov2Dims):
        super().__init__()
        self.w12 = nn.Linear(dims.hidden_size, 2 * dims.ffn_hidden)
        self.w3 = nn.Linear(dims.ffn_hidden, dims.hidden_size)


class Mlp(nn.Module):
    def __init__(self, dims: Dinov2Dims):
        super().__init__()
        self.fc1 = nn.Linear(dims.hidden_size, dims.ffn_hidden)
        self.fc2 = nn.Linear(dims.ffn_hidden, dims.hidden_size)


class Block(nn.Module):
    def __init__(self, dims: Dinov2Dims):
        super().__init__()
        h = dims.hidden_size
        self.norm1 = nn.LayerNorm(h, eps=dims.ln_eps)
        self.attn = Attention(dims)
        self.ls1 = LayerScale(dims)
        self.norm2 = nn.LayerNorm(h, eps=dims.ln_eps)
        self.mlp = SwiGLU(dims) if dims.ffn == "swiglu" else Mlp(dims)
        self.ls2 = LayerScale(dims)


class Dinov2(nn.Module):
    """The tower's weights under the public checkpoint's names (``cls_token``,
    ``register_tokens``, ``pos_embed``, ``patch_embed.proj.*``,
    ``blocks.N.*``, ``norm.*``); frozen."""

    def __init__(self, dims: Dinov2Dims, in_channels: int = 3):
        super().__init__()
        self.dims = dims
        h = dims.hidden_size
        self.cls_token = _frozen(1, 1, h)
        if dims.num_registers:
            self.register_tokens = _frozen(1, dims.num_registers, h)
        self.pos_embed = _frozen(1, 1 + dims.num_patches, h)
        self.patch_embed = PatchEmbed(dims, in_channels)
        self.blocks = nn.ModuleList(Block(dims) for _ in range(dims.depth))
        self.norm = nn.LayerNorm(h, eps=dims.ln_eps)
        self.requires_grad_(False)


def init_dinov2(dims: Dinov2Dims, generator: Optional[torch.Generator] = None) -> Dinov2:
    """Seeded random weights on the CPU: every weight, bias and token
    N(0, 0.02²), LayerNorm scales 1 + N(0, 0.1²), LayerScale gammas
    U(0.1, 0.5) (at DINOv2's 1e-5 initialisation a block would leave the
    residual stream as it was)."""
    generator = generator or torch.Generator().manual_seed(0)
    model = Dinov2(dims)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("gamma"):
                p.copy_(0.1 + 0.4 * torch.rand(p.shape, generator=generator))
            elif "norm" in name and name.endswith("weight"):
                p.copy_(1.0 + 0.1 * torch.randn(p.shape, generator=generator))
            else:
                p.copy_(0.02 * torch.randn(p.shape, generator=generator))
    return model.eval()


def load_dinov2_state_dict(state: Dict[str, torch.Tensor], dims: Optional[Dinov2Dims] = None) -> Dinov2:
    """A tower holding a ``facebookresearch/dinov2`` checkpoint's tensors:
    the port keeps their names, ``mask_token`` (used only in pre-training)
    is dropped, and every other tensor must match a parameter's name and
    shape (``load_state_dict(strict=True)`` names what does not)."""
    dims = dims or dinov2_vitg14_reg()
    model = Dinov2(dims)
    state = {k: v for k, v in state.items() if k != "mask_token"}
    model.load_state_dict(state, strict=True)
    return model.eval()


def load_dinov2_checkpoint(path, dims: Optional[Dinov2Dims] = None) -> Dinov2:
    """:func:`load_dinov2_state_dict` of a ``.pth`` file such as
    ``dinov2_vitg14_reg4_pretrain.pth`` (tensors only: no pickled code runs)."""
    return load_dinov2_state_dict(torch.load(path, map_location="cpu", weights_only=True), dims)


@torch.no_grad()
def fold_grayscale_patch_embed(model: Dinov2) -> Dinov2:
    """A tower whose patch embedding takes one grey plane in [0, 1].

    The pipeline's three channels are one plane copied, then normalised
    per channel as (x - mean_c) / std_c, so the 3-channel kernel W and bias
    b fold exactly into W' = sum_c W_c / std_c and b' = b - sum_c (mean_c /
    std_c) sum W_c (fp32).  The blocks and tokens are shared with ``model``,
    not copied."""
    proj = model.patch_embed.proj
    if proj.weight.shape[1] == 1:
        return model
    w = proj.weight.to(torch.float32)
    std = torch.tensor(IMAGENET_STD, device=w.device).view(1, 3, 1, 1)
    mean = torch.tensor(IMAGENET_MEAN, device=w.device).view(1, 3, 1, 1)
    folded = PatchEmbed(model.dims, in_channels=1).to(w.device)
    folded.proj.weight.copy_((w / std).sum(1, keepdim=True))
    folded.proj.bias.copy_(proj.bias.to(torch.float32) - (w * (mean / std)).sum((1, 2, 3)))
    out = copy.copy(model)
    # dicts of its own; the tensors and modules in them are shared
    out._parameters, out._modules = dict(model._parameters), dict(model._modules)
    out.patch_embed = folded
    return out


@torch.no_grad()
def cast_dinov2_blocks(model: Dinov2, dtype: torch.dtype) -> Dinov2:
    """A tower whose blocks and final LayerNorm hold ``dtype`` weights, cast
    once; the tokens and the patch embedding stay as they are (fp32, module
    docstring) and are shared with ``model``, which is left unchanged.
    ``model`` itself where its blocks already are ``dtype``."""
    cast = [p for m in (model.blocks, model.norm) for p in m.parameters()]
    if all(p.dtype == dtype for p in cast):
        return model
    memo = {id(p): nn.Parameter(p.to(dtype), requires_grad=False) for p in cast}
    out = copy.copy(model)
    out._parameters, out._modules = dict(model._parameters), dict(model._modules)
    out.blocks = copy.deepcopy(model.blocks, memo)
    out.norm = copy.deepcopy(model.norm, memo)
    return out


def _patch_tokens(model: Dinov2, images: torch.Tensor) -> torch.Tensor:
    """(B, S, S, C) pixels in [0, 1] -> (B, N, H) fp32 patch embeddings
    plus their position embeddings; three channels are normalised first."""
    dims = model.dims
    b, s, s2, c = images.shape
    w = model.patch_embed.proj.weight
    if s != dims.image_size or s2 != s:
        raise ValueError(f"expected {dims.image_size}² images (the position embedding's "
                         f"{dims.grid} x {dims.grid} grid), got {s} x {s2}")
    if c != w.shape[1]:
        raise ValueError(f"the patch embedding takes {w.shape[1]} channel(s), the images have {c}"
                         + (" (fold it with fold_grayscale_patch_embed)" if c == 1 else ""))
    x = images.to(torch.float32)
    if c == 3:
        mean = torch.tensor(IMAGENET_MEAN, device=x.device)
        std = torch.tensor(IMAGENET_STD, device=x.device)
        x = (x - mean) / std
    g, p = dims.grid, dims.patch_size
    # (B, g, p, g, p, C) -> (B, g, g, C, p, p): the conv kernel's (C, kh, kw) order
    x = x.reshape(b, g, p, g, p, c).permute(0, 1, 3, 5, 2, 4).reshape(b, g * g, c * p * p)
    x = F.linear(x, w.to(torch.float32).reshape(w.shape[0], -1),
                 model.patch_embed.proj.bias.to(torch.float32))
    return x + model.pos_embed[:, 1:].to(torch.float32)


def _linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    # the weight follows the activation's type: bf16 GEMMs under bf16 (no
    # copy once cast_dinov2_blocks has cast the blocks)
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


def _layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, ln.normalized_shape, ln.weight.to(x.dtype), ln.bias.to(x.dtype), ln.eps)


def _attention(attn: Attention, x: torch.Tensor, dims: Dinov2Dims, ids: torch.Tensor) -> torch.Tensor:
    b, t, h = x.shape
    nh, hd = dims.num_heads, dims.head_dim
    qkv = _linear(attn.qkv, x)
    q, k, v = (u.reshape(b, t, nh, hd).transpose(1, 2) for u in qkv.split(h, dim=-1))
    ctx = flash_attention(q, k, v, ids, ids, sm_scale=1.0 / math.sqrt(hd))
    count("vit_attention_launches")
    return _linear(attn.proj, ctx.transpose(1, 2).reshape(b, t, h))


def _ffn(mlp: nn.Module, x: torch.Tensor) -> torch.Tensor:
    if isinstance(mlp, SwiGLU):
        a, b = _linear(mlp.w12, x).chunk(2, dim=-1)
        return _linear(mlp.w3, F.silu(a) * b)
    return _linear(mlp.fc2, F.gelu(_linear(mlp.fc1, x)))


def dinov2_forward(model: Dinov2, images: torch.Tensor, dtype: torch.dtype = torch.float32,
                   int8: bool = False) -> torch.Tensor:
    """(B, S, S, C) pixels in [0, 1] -> (B, 2H) fp32 [CLS ; patch mean]
    embeddings (module docstring).  ``C`` is 3 (normalised here) or 1 for a
    tower from :func:`fold_grayscale_patch_embed`."""
    if int8:
        raise ValueError("the DINOv2 tower has no int8 path; extract it in bf16 or fp32")
    dims = model.dims
    b = images.shape[0]
    with annotate("vit-encode"):
        patches = _patch_tokens(model, images)
        cls = (model.cls_token + model.pos_embed[:, :1]).to(torch.float32).expand(b, -1, -1)
        parts = [cls, patches]
        if dims.num_registers:
            parts.insert(1, model.register_tokens.to(torch.float32).expand(b, -1, -1))
        x = torch.cat(parts, dim=1).to(dtype)
        ids = torch.ones((b, x.shape[1]), dtype=torch.int32, device=x.device)  # one segment
        for blk in model.blocks:
            x = torch.addcmul(x, _attention(blk.attn, _layer_norm(blk.norm1, x), dims, ids),
                              blk.ls1.gamma.to(dtype))
            x = torch.addcmul(x, _ffn(blk.mlp, _layer_norm(blk.norm2, x)), blk.ls2.gamma.to(dtype))
        z = _layer_norm(model.norm, x)
        out = torch.cat([z[:, 0].to(torch.float32),
                         torch.mean(z[:, 1 + dims.num_registers:], dim=1, dtype=torch.float32)], dim=1)
    count("vit_images", b)
    count("vit_tokens", b * x.shape[1])
    return out
