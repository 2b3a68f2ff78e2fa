"""Frozen-BN ResNet-50 trunk (BioViL image encoder backbone).

Counterpart of the JAX package's ``models/resnet.py``: torchvision-v1
Bottleneck [3, 4, 6, 3], stride on the 3x3 conv, 1x1-conv downsample, the
7x7/2 stem and a 3x3/2 max pool.  Batch norm is inference-only, evaluated
as the JAX package does: scale and shift computed in fp32 from the stored
statistics, cast to the compute dtype, then ``x * scale + shift``.

Layout: modules hold OIHW weights; activations run NCHW-indexed in
``channels_last`` memory, so the NHWC tensors at the public functions
(:func:`resnet50_forward` takes and returns NHWC, as the JAX function
does) are permuted views, and the ``layer1_fn`` hook receives NHWC without
a copy.  The convolutions are ``F.conv2d`` (XLA runs them outside any
Pallas kernel on the JAX side).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-5  # torch BatchNorm2d default
RESNET50_LAYERS = (3, 4, 6, 3)
RESNET50_WIDTHS = (64, 128, 256, 512)
EXPANSION = 4


class Conv2d(nn.Module):
    """Bias-free conv with a frozen OIHW weight; computes in the input's dtype."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, padding: int = 0):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k), requires_grad=False)
        self.stride = stride
        self.padding = padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(dtype=x.dtype, memory_format=torch.channels_last)
        return F.conv2d(x, w, stride=self.stride, padding=self.padding)


class FrozenBatchNorm(nn.Module):
    """Inference batch norm with the JAX package's parameter names."""

    def __init__(self, c: int):
        super().__init__()
        self.register_buffer("scale", torch.ones(c))
        self.register_buffer("bias", torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        root = torch.sqrt(self.var + BN_EPS)
        scale = (self.scale / root).to(x.dtype)
        shift = (self.bias - self.mean * self.scale / root).to(x.dtype)
        return x * scale.view(1, -1, 1, 1) + shift.view(1, -1, 1, 1)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, width: int, stride: int):
        super().__init__()
        cout = width * EXPANSION
        self.conv1 = Conv2d(cin, width, 1)
        self.bn1 = FrozenBatchNorm(width)
        self.conv2 = Conv2d(width, width, 3, stride=stride, padding=1)
        self.bn2 = FrozenBatchNorm(width)
        self.conv3 = Conv2d(width, cout, 1)
        self.bn3 = FrozenBatchNorm(cout)
        if stride != 1 or cin != cout:
            self.downsample_conv = Conv2d(cin, cout, 1, stride=stride)
            self.downsample_bn = FrozenBatchNorm(cout)
        else:
            self.downsample_conv = None
            self.downsample_bn = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample_conv is not None:
            identity = self.downsample_bn(self.downsample_conv(x))
        else:
            identity = x
        return torch.relu(out + identity)


class ResNet50(nn.Module):
    def __init__(self, in_channels: int = 3):
        super().__init__()
        self.conv1 = Conv2d(in_channels, 64, 7, stride=2, padding=3)
        self.bn1 = FrozenBatchNorm(64)
        cin = 64
        for li, (blocks, width) in enumerate(zip(RESNET50_LAYERS, RESNET50_WIDTHS)):
            stride = 1 if li == 0 else 2
            layer = []
            for bi in range(blocks):
                layer.append(Bottleneck(cin, width, stride if bi == 0 else 1))
                cin = width * EXPANSION
            setattr(self, f"layer{li + 1}", nn.ModuleList(layer))


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """torch MaxPool2d(kernel=3, stride=2, padding=1); padding is -inf."""
    return F.max_pool2d(x, kernel_size=3, stride=2, padding=1)


def resnet50_forward(
    model: ResNet50,
    x_nhwc: torch.Tensor,
    dtype: torch.dtype = torch.float32,
    layer1_fn=None,
) -> torch.Tensor:
    """(B, H, W, C) -> x4 (B, H/32, W/32, 2048), NHWC.

    ``layer1_fn``, if given, replaces the whole stride-1 layer1 block chain
    (the hook for the fused kernel, ``ops/fused_bottleneck.py``); it takes
    and returns NHWC.
    """
    x = x_nhwc.to(dtype).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    out = max_pool_3x3_s2(torch.relu(model.bn1(model.conv1(x))))
    for li in range(4):
        if li == 0 and layer1_fn is not None:
            nhwc = out.permute(0, 2, 3, 1).contiguous()
            out = layer1_fn(nhwc).permute(0, 3, 1, 2)
            continue
        for block in getattr(model, f"layer{li + 1}"):
            out = block(out)
    return out.permute(0, 2, 3, 1)


# ----------------------------------------------------------------------
# Random initialisation (production weights come from convert.py)
# ----------------------------------------------------------------------
@torch.no_grad()
def init_conv_(conv: Conv2d, generator: torch.Generator) -> None:
    """torch kaiming_normal_(fan_out, relu), drawn from ``generator``."""
    cout, _, kh, kw = conv.weight.shape
    std = float(np.sqrt(2.0 / (kh * kw * cout)))
    conv.weight.normal_(0.0, std, generator=generator)


def init_resnet50(generator: Optional[torch.Generator] = None, in_channels: int = 3) -> ResNet50:
    """A ResNet-50 with seeded kaiming-normal convs and identity BN, on the CPU."""
    generator = generator or torch.Generator().manual_seed(0)
    model = ResNet50(in_channels)
    for m in model.modules():
        if isinstance(m, Conv2d):
            init_conv_(m, generator)
    return model.eval()
