"""Fused ResNet bottleneck layer1 (counterpart of the JAX package's
``ops/pallas_bottleneck.py``).

:func:`fold_bottleneck_layer` folds frozen BN into the weights, in the
JAX package's layout and with its b3+bd merge; :func:`folded_layer` keeps
that fold with the layer, so a model folds once and not on every forward.
:func:`fused_bottleneck_layer` runs the whole stride-1 layer (3 bottleneck
blocks, 64 -> 256 channels) through the hand-written CUDA kernel
``csrc/fused_bottleneck.cu`` (one launch a block), and
:func:`fused_bottleneck_layer_reference` is its plain PyTorch version: the
same block math in fp32 ops on bf16-valued tensors, rounding to bf16 where
the TPU kernel rounds.  The wrapper takes the plain version for a tensor
on the CPU and the kernel for one on CUDA.

No-grad paths only: the kernel has no backward.  As ``jax.grad`` through
the Pallas kernel fails, the wrapper raises, on every device, when grad
mode is on and ``x`` or a folded tensor requires grad, instead of
returning a result cut from the autograd graph.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Dict, List, NamedTuple

import torch
import torch.nn.functional as F

from incremental_multimodal_medical_learning_ii_torch.models.resnet import BN_EPS
from incremental_multimodal_medical_learning_ii_torch.ops.cuda_build import current_stream, launcher

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p]
WIDTH, COUT = 64, 256  # the bottleneck width and output channels the kernel is built for
ROW = 64  # channels in one 128-byte row of a weight tile


class Folded(dict):
    """``{name: per-block tensors}`` as :func:`fold_bottleneck_layer` returns
    it.  ``kernel_weights`` keeps the kernel's layout of them per device,
    made at the first launch there; the tensors are not to be changed
    after folding."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.kernel_weights: Dict[torch.device, list] = {}


def _fold_conv_bn(weight: torch.Tensor, bn) -> tuple:
    """OIHW conv weight + frozen BN -> HWIO scaled kernel and bias."""
    k = weight.detach().to(torch.float32).permute(2, 3, 1, 0)
    scale = bn.scale / torch.sqrt(bn.var + BN_EPS)
    bias = bn.bias - bn.mean * scale
    return k * scale, bias


@torch.no_grad()
def fold_bottleneck_layer(layer) -> Folded:
    """Fold a stride-1 bottleneck layer's BN into matmul-shaped weights.

    Returns per-block lists in the JAX package's layout: w1 (Cin, Cm),
    w2 (9*Cm, Cm) dx-major (row = dx*3*Cm + dy*Cm + c), w3 (Cm, Cout) and
    wd (Cin, Cout) in bf16; b1/b2 (1, Cm) and b3 (1, Cout) in fp32, with
    the downsample bias merged into b3 of the block that has one.
    """
    out = Folded({k: [] for k in ("w1", "b1", "w2", "b2", "w3", "b3", "wd")})
    for block in layer:
        k1, b1 = _fold_conv_bn(block.conv1.weight, block.bn1)
        k2, b2 = _fold_conv_bn(block.conv2.weight, block.bn2)
        k3, b3 = _fold_conv_bn(block.conv3.weight, block.bn3)
        cm = k1.shape[3]
        out["w1"].append(k1.reshape(k1.shape[2], cm).to(torch.bfloat16))
        out["w2"].append(k2.permute(1, 0, 2, 3).reshape(9 * cm, cm).to(torch.bfloat16))
        out["w3"].append(k3.reshape(cm, k3.shape[3]).to(torch.bfloat16))
        out["b1"].append(b1.reshape(1, -1).to(torch.float32))
        out["b2"].append(b2.reshape(1, -1).to(torch.float32))
        if block.downsample_conv is not None:
            kd, bd = _fold_conv_bn(block.downsample_conv.weight, block.downsample_bn)
            out["wd"].append(kd.reshape(kd.shape[2], kd.shape[3]).to(torch.bfloat16))
            b3 = b3 + bd  # one combined bias for the residual sum
        out["b3"].append(b3.reshape(1, -1).to(torch.float32))
    return out


_FOLDS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def folded_layer(layer) -> Folded:
    """:func:`fold_bottleneck_layer` of ``layer``, kept with the layer and
    folded again only when one of its parameters or buffers has changed:
    in place (a new tensor version), or replaced, or moved to another
    device (new storage)."""
    key = tuple((t.data_ptr(), t.device, t._version)
                for t in (*layer.parameters(), *layer.buffers()))
    hit = _FOLDS.get(layer)
    if hit is None or hit[0] != key:
        hit = _FOLDS[layer] = (key, fold_bottleneck_layer(layer))
    return hit[1]


def fused_bottleneck_layer_reference(
    x: torch.Tensor, folded: Folded, sum_dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """Plain version: (B, H, W, Cin) -> (B, H, W, Cout) bf16.

    Sums in ``sum_dtype`` (float32, as the TPU kernel) over bf16-valued
    tensors, with bf16 rounding after conv1+ReLU, after conv2+ReLU and
    after the residual ReLU; the 3x3 is zero-padded (no row outside the
    image carries relu(b1)) and summed as three dx-grouped products, as
    the TPU kernel does.  Not the cuDNN bf16 conv chain, which rounds
    elsewhere.  ``sum_dtype=torch.float64`` gives the same roundings over
    near-exact sums: the yardstick for how far summation order alone moves
    a bf16 result.
    """
    f = sum_dtype
    t = x.to(torch.bfloat16)
    _, h, w, _ = t.shape
    for bi in range(len(folded["w1"])):
        cm = folded["w1"][bi].shape[1]
        a = torch.relu(t.to(f) @ folded["w1"][bi].to(f) + folded["b1"][bi].to(f))
        ap = F.pad(a.to(torch.bfloat16).to(f), (0, 0, 1, 1, 1, 1))  # zero H and W borders
        w2 = folded["w2"][bi].to(f)
        acc = None
        for dx in range(3):
            group = torch.cat([ap[:, dy : dy + h, dx : dx + w, :] for dy in range(3)], dim=-1)
            d = group @ w2[dx * 3 * cm : (dx + 1) * 3 * cm]
            acc = d if acc is None else acc + d
        hid = torch.relu(acc + folded["b2"][bi].to(f)).to(torch.bfloat16)
        out = hid.to(f) @ folded["w3"][bi].to(f) + folded["b3"][bi].to(f)
        if bi == 0 and folded["wd"]:
            ident = t.to(f) @ folded["wd"][0].to(f)
        else:
            ident = t.to(f)
        t = torch.relu(out + ident).to(torch.bfloat16)
    return t


def _swizzle_rows(tile: torch.Tensor) -> torch.Tensor:
    """(R, 64) -> the same rows in the 128-byte swizzle of shared memory
    (TMA's SWIZZLE_128B): the 8-channel group q of row r holds the row's
    group q ^ (r % 8)."""
    r = tile.shape[0]
    groups = tile.reshape(r, ROW // 8, 8)
    idx = torch.arange(ROW // 8, device=tile.device)[None, :] ^ (
        torch.arange(r, device=tile.device) % 8)[:, None]
    return groups[torch.arange(r, device=tile.device)[:, None], idx].reshape(r, ROW)


class BlockWeights(NamedTuple):
    image: torch.Tensor  # bf16: the block's weights as the kernel's shared memory holds them
    b1: torch.Tensor  # (64,) fp32
    b2: torch.Tensor  # (64,) fp32
    b3: torch.Tensor  # (256,) fp32, the downsample's bias included
    downsample: bool  # Cin = 64 with the downsample product; else Cin = 256, identity


def _kernel_weights(folded: Folded, device: torch.device) -> List[BlockWeights]:
    """Per block, the kernel's weights on ``device``.  The image is a run
    of 128-byte-swizzled tiles of 64-channel rows (:func:`_swizzle_rows`),
    each output channel a row with its input channels along it: w1 as
    Cin/64 tiles of 64 x 64 (input channels 64 k .. 64 k + 63), w2 as the
    9 taps dy-major (tap dy*3 + dx) of 64 x 64, w3 as 256 x 64, and wd as
    256 x 64 for the block with the downsample."""
    blocks = []
    for bi in range(len(folded["w1"])):
        w1 = folded["w1"][bi].t()  # (64, Cin)
        cm = w1.shape[0]
        # dx-major (dx, dy, c_in, c_out) -> (dy, dx, c_out, c_in)
        w2 = folded["w2"][bi].reshape(3, 3, cm, cm).permute(1, 0, 3, 2)
        tiles = [w1[:, k : k + ROW] for k in range(0, w1.shape[1], ROW)]
        tiles += [w2[dy, dx] for dy in range(3) for dx in range(3)]
        tiles.append(folded["w3"][bi].t())
        down = bi == 0 and bool(folded["wd"])
        if down:
            tiles.append(folded["wd"][0].t())
        image = torch.cat([_swizzle_rows(t.to(torch.bfloat16)).reshape(-1) for t in tiles])

        def dev(t):
            return t.reshape(-1).to(device=device, dtype=torch.float32).contiguous()

        blocks.append(BlockWeights(image.to(device).contiguous(), dev(folded["b1"][bi]),
                                   dev(folded["b2"][bi]), dev(folded["b3"][bi]), down))
    return blocks


def _check_widths(cin: int, folded: Folded) -> None:
    """The widths the kernel's tiling takes: width 64, 256 outputs; a
    block with the downsample takes 64 channels, one without 256."""
    for bi, w1 in enumerate(folded["w1"]):
        down = bi == 0 and bool(folded["wd"])
        cm, cout = w1.shape[1], folded["w3"][bi].shape[1]
        if w1.shape[0] != cin or cm != WIDTH or cout != COUT or cin != (WIDTH if down else COUT):
            raise ValueError(f"unsupported widths in block {bi}: Cin={cin} (w1 takes "
                             f"{w1.shape[0]}), width={cm}, Cout={cout}, downsample={down}")
        cin = cout


def _block(t: torch.Tensor, w: BlockWeights) -> torch.Tensor:
    """One kernel launch: one block, NHWC bf16 in, (B, H, W, 256) bf16 out."""
    fn = launcher("fused_bottleneck", "bottleneck_block_launch", _ARGTYPES)
    n, h, wd, cin = t.shape
    out = torch.empty((n, h, wd, COUT), dtype=torch.bfloat16, device=t.device)
    rc = fn(t.data_ptr(), w.image.data_ptr(), w.b1.data_ptr(), w.b2.data_ptr(), w.b3.data_ptr(),
            out.data_ptr(), n, h, wd, cin, int(w.downsample), current_stream(t))
    if rc != 0:
        raise RuntimeError(f"fused_bottleneck kernel launch failed: CUDA error {rc}")
    fused_bottleneck_layer.launches += 1
    return out


def fused_bottleneck_layer(x: torch.Tensor, folded: Folded) -> torch.Tensor:
    """(B, H, W, Cin) bf16 NHWC -> (B, H, W, Cout) bf16 through the layer.

    On CUDA: the hand-written kernel, one launch a block (each counted in
    ``fused_bottleneck_layer.launches``), any H and W; the layer1 widths
    only (Cin 64, width 64, Cout 256).  On the CPU: the plain version.
    """
    if torch.is_grad_enabled() and (x.requires_grad or any(
            t.requires_grad for ts in folded.values() for t in ts)):
        raise RuntimeError("fused_bottleneck_layer has no backward: run it under torch.no_grad(), "
                           "or use fused_bottleneck_layer_reference where gradients must flow")
    if x.device.type == "cpu":
        return fused_bottleneck_layer_reference(x, folded)
    if x.device.type != "cuda":
        raise ValueError(f"fused_bottleneck_layer: unsupported device {x.device}")
    if x.dim() != 4 or x.dtype != torch.bfloat16:
        raise ValueError(f"expected (B, H, W, C) bfloat16, got {tuple(x.shape)} {x.dtype}")
    _check_widths(x.shape[3], folded)
    memo = getattr(folded, "kernel_weights", None)
    blocks = memo.get(x.device) if memo is not None else None
    if blocks is None:
        blocks = _kernel_weights(folded, x.device)
        if memo is not None:
            memo[x.device] = blocks
    t = x.contiguous()
    if t.data_ptr() % 16:  # TMA reads from 16-byte-aligned addresses
        t = t.clone()
    for w in blocks:
        t = _block(t, w)
    return t


fused_bottleneck_layer.launches = 0
