"""Int8 inference path for the frozen BioViL extraction trunk (counterpart
of the JAX package's ``ops/quant.py``).

The extraction encoder never trains (the reference freezes it,
``chexpert-get-embedding.py:41-42``), so post-training quantization
applies.  The scheme is the JAX package's, in its arithmetic order:

* **weights**: per-output-channel symmetric int8, folded once on the host
  (:func:`quantize_resnet_int8`): ``scale = max(max|w| / 127, 1e-12)`` over
  (cin, kh, kw), ``round`` half to even, clipped to +-127;
* **activations**: dynamic per-tensor symmetric int8 per conv input,
  ``s_x = max(max|x|, 1e-12) / 127`` (as the JAX forward computes it
  under ``jit``: times the fp32 reciprocal of 127);
* **accumulation**: int32, dequantised as ``acc.float() * (s_x * w_scale)``
  (the scale product formed first) to the network's dtype before batch
  norm, ReLU and residual adds.

torch has no int8 convolution.  On CUDA the sums are im2col followed by
``torch._int_mm`` (int32 accumulation; K is padded with zero columns to a
multiple of 8 and M past 16 rows with zero rows, which leaves the sums
unchanged).  On the CPU they are ``F.conv2d`` in float64 on the
integer-valued operands: every partial sum stays below 2^53, so the result
is exact (float32 would not be: 127^2 * 4608 > 2^24).  A CUDA tensor never
takes the CPU path.  This is not a Pallas kernel's port, so it stays
plain PyTorch.

The 1x1-conv projector stays in float (``models/biovil_image.py::
quantize_biovil_int8``).
"""

from __future__ import annotations

import copy
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from incremental_multimodal_medical_learning_ii_torch.models.resnet import Conv2d, ResNet50


class Int8Conv2d(nn.Module):
    """A quantized frozen conv: ``kernel_q`` (cout, cin, kh, kw) int8 and
    ``w_scale`` (cout,) fp32; run it through :func:`conv_apply_int8`."""

    def __init__(self, kernel_q: torch.Tensor, w_scale: torch.Tensor, stride: int, padding: int):
        super().__init__()
        self.register_buffer("kernel_q", kernel_q)
        self.register_buffer("w_scale", w_scale)
        self.stride = stride
        self.padding = padding

    def forward(self, x: torch.Tensor, **overrides) -> torch.Tensor:
        raise RuntimeError("an int8-quantized conv runs through conv_apply_int8 "
                           "(biovil_image_forward(..., int8=True))")


@torch.no_grad()
def quantize_conv_int8(conv: Conv2d) -> Int8Conv2d:
    """A float :class:`Conv2d` -> int8 kernel + per-cout scale."""
    k = conv.weight.detach().to(torch.float32)
    scale = torch.amax(torch.abs(k), dim=(1, 2, 3)) / 127.0
    scale = torch.clamp_min(scale, 1e-12)
    kq = torch.clamp(torch.round(k / scale.view(-1, 1, 1, 1)), -127, 127).to(torch.int8)
    return Int8Conv2d(kq, scale, conv.stride, conv.padding)


def _is_quantized(model: nn.Module) -> bool:
    return any(isinstance(m, Int8Conv2d) for m in model.modules())


@torch.no_grad()
def quantize_resnet_int8(model: ResNet50) -> ResNet50:
    """A copy of ``model`` with every conv quantized (batch norms untouched).
    Refuses a model that is quantized already."""
    if _is_quantized(model):
        raise ValueError("the trunk is int8-quantized already; quantize the float model once")
    out = copy.deepcopy(model)
    for module in list(out.modules()):
        for name, child in list(module.named_children()):
            if isinstance(child, Conv2d):
                setattr(module, name, quantize_conv_int8(child))
    return out


def quantize_activation(x: torch.Tensor):
    """Dynamic per-tensor symmetric int8: (xq int8, s_x fp32 0-d).

    ``s_x`` is ``max|x|`` times the fp32 reciprocal of 127: the JAX source
    divides by 127, but its forward runs under ``jit``, where XLA turns a
    division by a constant into that product (the weights' scales are
    computed eagerly, as true divisions)."""
    x32 = x.to(torch.float32)
    s_x = torch.clamp_min(torch.amax(torch.abs(x32)), 1e-12) * _RECIP_127
    xq = torch.clamp(torch.round(x32 / s_x), -127, 127).to(torch.int8)
    return xq, s_x


_RECIP_127 = float(np.float32(1.0) / np.float32(127.0))


def _pad_to(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def _int_mm_conv(xq: torch.Tensor, kq: torch.Tensor, stride: int, padding: int,
                 dilation: int = 1) -> torch.Tensor:
    """CUDA: im2col of the NHWC int8 activations, then ``torch._int_mm``.
    A dilated window is unfolded at its full extent and every
    ``dilation``-th tap kept."""
    b = xq.shape[0]
    cout, cin, kh, kw = kq.shape
    x = xq.permute(0, 2, 3, 1)  # NHWC (a view of the channels_last tensor)
    if padding:
        x = F.pad(x, (0, 0, padding, padding, padding, padding))
    span_h, span_w = dilation * (kh - 1) + 1, dilation * (kw - 1) + 1
    patches = x.unfold(1, span_h, stride).unfold(2, span_w, stride)  # (B, Ho, Wo, C, span_h, span_w)
    if dilation != 1:
        patches = patches[..., ::dilation, ::dilation]
    ho, wo = patches.shape[1], patches.shape[2]
    m, k = b * ho * wo, cin * kh * kw
    a = patches.reshape(m, k)
    w = kq.reshape(cout, k)
    k8, m17 = _pad_to(k, 8), max(m, 17)
    if k8 != k:
        a = F.pad(a, (0, k8 - k))
        w = F.pad(w, (0, k8 - k))
    if m17 != m:
        a = F.pad(a, (0, 0, 0, m17 - m))
    if cout % 8:
        raise ValueError(f"torch._int_mm needs cout a multiple of 8, got {cout}")
    acc = torch._int_mm(a.contiguous(), w.t())[:m]
    return acc.view(b, ho, wo, cout).permute(0, 3, 1, 2)


def conv_int8_sums(xq: torch.Tensor, kq: torch.Tensor, stride: int, padding: int,
                   dilation: int = 1) -> torch.Tensor:
    """The int32 sums of an int8 convolution: ``xq`` (B, C, H, W) int8
    (any memory format), ``kq`` (cout, cin, kh, kw) int8 -> (B, cout, Ho,
    Wo) int32.  im2col + ``torch._int_mm`` on CUDA; exact float64
    ``F.conv2d`` on the CPU."""
    if xq.device != kq.device:
        raise ValueError(f"operands on {xq.device} and {kq.device}")
    if xq.device.type == "cuda":
        return _int_mm_conv(xq, kq, stride, padding, dilation)
    if xq.device.type != "cpu":
        raise ValueError(f"the int8 conv runs on cuda or cpu, not {xq.device}")
    acc = F.conv2d(xq.to(torch.float64), kq.to(torch.float64), stride=stride, padding=padding,
                   dilation=dilation)
    return acc.to(torch.int32)


def conv_apply_int8(conv: nn.Module, x: torch.Tensor, stride: Optional[int] = None,
                    padding: Optional[int] = None, dilation: int = 1) -> torch.Tensor:
    """Int8 conv: dynamic per-tensor activation scale, per-channel weight
    scales, int32 sums, dequantised back to ``x.dtype``.  Drop-in for
    :func:`models.resnet.conv_apply` through the forwards' ``conv``
    argument (the conv's own stride and padding unless given)."""
    if not isinstance(conv, Int8Conv2d):
        raise ValueError("int8=True expects a trunk from quantize_biovil_int8")
    xq, s_x = quantize_activation(x)
    acc = conv_int8_sums(xq, conv.kernel_q, conv.stride if stride is None else stride,
                         conv.padding if padding is None else padding, dilation)
    scale = s_x * conv.w_scale
    out = acc.to(torch.float32) * scale.view(1, -1, 1, 1)
    return out.to(x.dtype)
