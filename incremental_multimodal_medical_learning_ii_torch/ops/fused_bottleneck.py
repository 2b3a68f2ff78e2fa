"""Fused ResNet bottleneck layer1 (counterpart of the JAX package's
``ops/pallas_bottleneck.py``).

:func:`fold_bottleneck_layer` folds frozen BN into the weights, in the
JAX package's layout and with its b3+bd merge.  :func:`fused_bottleneck_layer`
runs the whole stride-1 layer (3 bottleneck blocks, 64 -> 256 channels)
through the hand-written CUDA kernel ``csrc/fused_bottleneck.cu`` (three
launches a block), and :func:`fused_bottleneck_layer_reference` is its
plain PyTorch version: the same block math in fp32 ops on bf16-valued
tensors, rounding to bf16 where the TPU kernel rounds.  The wrapper takes
the plain version for a tensor on the CPU and the kernel for one on CUDA.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List

import torch
import torch.nn.functional as F

from incremental_multimodal_medical_learning_ii_torch.models.resnet import BN_EPS
from incremental_multimodal_medical_learning_ii_torch.ops.cuda_build import current_stream, launcher

Folded = Dict[str, List[torch.Tensor]]
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p]


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
    out: Folded = {k: [] for k in ("w1", "b1", "w2", "b2", "w3", "b3", "wd")}
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


def _kernel_weights(folded: Folded, device: torch.device) -> list:
    """Per block: (w1, b1, w2, b2, w3, b3) in the kernel's layout, output
    channel major with K contiguous; the 3x3 taps are dy-major
    (k = (dy*3 + dx)*Cm + c)."""
    blocks = []
    for bi in range(len(folded["w1"])):
        cm = folded["w1"][bi].shape[1]

        def dev(t, dtype):
            return t.to(device=device, dtype=dtype).contiguous()

        w2 = folded["w2"][bi].reshape(3, 3, cm, cm).permute(3, 1, 0, 2).reshape(cm, 9 * cm)
        blocks.append((
            dev(folded["w1"][bi].t(), torch.bfloat16),
            dev(folded["b1"][bi].reshape(-1), torch.float32),
            dev(w2, torch.bfloat16),
            dev(folded["b2"][bi].reshape(-1), torch.float32),
            dev(folded["w3"][bi].t(), torch.bfloat16),
            dev(folded["b3"][bi].reshape(-1), torch.float32),
        ))
    wd = folded["wd"][0].t().to(device=device, dtype=torch.bfloat16).contiguous() if folded["wd"] else None
    return blocks, wd


def _conv_gemm(a0, w0, taps, a1, w1, bias, resid, relu: bool) -> torch.Tensor:
    """One launch of the implicit-GEMM kernel: NHWC bf16 in, NHWC bf16 out."""
    fn = launcher("fused_bottleneck", "conv_gemm_bf16_launch", _ARGTYPES)
    n, h, w, c0 = a0.shape
    cout = w0.shape[0]
    out = torch.empty((n, h, w, cout), dtype=torch.bfloat16, device=a0.device)
    rc = fn(a0.data_ptr(), w0.data_ptr(), taps, c0,
            a1.data_ptr() if a1 is not None else None,
            w1.data_ptr() if w1 is not None else None,
            a1.shape[3] if a1 is not None else 0,
            bias.data_ptr(), resid.data_ptr() if resid is not None else None,
            out.data_ptr(), n, h, w, cout, int(relu), current_stream(a0))
    if rc != 0:
        raise RuntimeError(f"fused_bottleneck kernel launch failed: CUDA error {rc}")
    fused_bottleneck_layer.launches += 1
    return out


def fused_bottleneck_layer(x: torch.Tensor, folded: Folded) -> torch.Tensor:
    """(B, H, W, Cin) bf16 NHWC -> (B, H, W, Cout) bf16 through the layer.

    On CUDA: the hand-written kernel, three launches a block (each counted
    in ``fused_bottleneck_layer.launches``).  On the CPU: the plain version.
    Needs Cin and the bottleneck width divisible by 32 and Cout by 64.
    """
    if x.device.type == "cpu":
        return fused_bottleneck_layer_reference(x, folded)
    if x.device.type != "cuda":
        raise ValueError(f"fused_bottleneck_layer: unsupported device {x.device}")
    if x.dim() != 4 or x.dtype != torch.bfloat16:
        raise ValueError(f"expected (B, H, W, C) bfloat16, got {tuple(x.shape)} {x.dtype}")
    cin = x.shape[3]
    cm = folded["w1"][0].shape[1]
    cout = folded["w3"][0].shape[1]
    if cin % 32 or cm % 32 or cout % 64 or folded["w1"][0].shape[0] != cin:
        raise ValueError(f"unsupported widths Cin={cin}, Cm={cm}, Cout={cout}")
    blocks, wd = _kernel_weights(folded, x.device)
    t = x.contiguous()
    for bi, (w1, b1, w2, b2, w3, b3) in enumerate(blocks):
        a = _conv_gemm(t, w1, 1, None, None, b1, None, relu=True)
        hid = _conv_gemm(a, w2, 9, None, None, b2, None, relu=True)
        if bi == 0 and wd is not None:
            t = _conv_gemm(hid, w3, 1, t, wd, b3, None, relu=True)
        else:
            t = _conv_gemm(hid, w3, 1, None, None, b3, t, relu=True)
    return t


fused_bottleneck_layer.launches = 0
