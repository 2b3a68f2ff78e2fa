"""Frozen-BN ResNet-50 and ResNet-18 trunks (BioViL image encoder backbone).

Counterpart of the JAX package's ``models/resnet.py``: torchvision-v1
Bottleneck [3, 4, 6, 3], stride on the 3x3 conv, 1x1-conv downsample, the
7x7/2 stem and a 3x3/2 max pool; torchvision's ``replace_stride_with_dilation``
for layers 2-4; the BasicBlock [2, 2, 2, 2] ResNet-18; and the exact
space-to-depth reformulation of the stem (a 4x4 stride-1 kernel over 2x2
space-to-depth input, :func:`space_to_depth_stem_kernel`), which the
forward selects from the stem kernel's shape.  Batch norm is
inference-only, evaluated as the JAX package does: scale and shift computed
in fp32 from the stored statistics, cast to the compute dtype, then
``x * scale + shift``.

Each conv's batch norm, residual add and ReLU go through one helper,
:func:`bn_epilogue`.  With the default convs (:func:`fuses_epilogue`), a
conv output the kernel takes (CUDA bf16 ``channels_last``) gets them in one
pass of ``ops/conv_epilogue.py``'s kernel, in fp32 with one rounding to
bf16; every other run (the CPU, fp32, the int8 convs) takes the chain of
torch ops above.  A ``layer1_fn`` hook replaces layer1 and its epilogues
alike; the stem and layers 2-4 around it fuse as they do without it.

Layout: modules hold OIHW weights; activations run NCHW-indexed in
``channels_last`` memory, so the NHWC tensors at the public functions
(:func:`resnet50_forward` takes and returns NHWC, as the JAX function
does) are permuted views, and the ``layer1_fn`` hook receives NHWC without
a copy.  The convolutions are ``F.conv2d`` (XLA runs them outside any
Pallas kernel on the JAX side).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from incremental_multimodal_medical_learning_ii_torch.ops import conv_epilogue
from incremental_multimodal_medical_learning_ii_torch.utils.profiling import count

BN_EPS = 1e-5  # torch BatchNorm2d default
RESNET50_LAYERS = (3, 4, 6, 3)
RESNET18_LAYERS = (2, 2, 2, 2)
RESNET50_WIDTHS = (64, 128, 256, 512)
EXPANSION = 4  # Bottleneck; BasicBlock (ResNet-18) has expansion 1


class Conv2d(nn.Module):
    """Bias-free conv with a frozen OIHW weight; computes in the input's dtype.

    ``stride`` and ``padding`` are fixed when it is built; a call may
    override them, and set ``dilation`` (a dilated layer runs the same
    weights at stride 1)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, padding: int = 0):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k), requires_grad=False)
        self.stride = stride
        self.padding = padding

    def forward(self, x: torch.Tensor, stride: Optional[int] = None,
                padding: Optional[int] = None, dilation: int = 1) -> torch.Tensor:
        w = self.weight.to(dtype=x.dtype, memory_format=torch.channels_last)
        return F.conv2d(x, w, stride=self.stride if stride is None else stride,
                        padding=self.padding if padding is None else padding, dilation=dilation)


class FrozenBatchNorm(nn.Module):
    """Inference batch norm with the JAX package's parameter names."""

    def __init__(self, c: int):
        super().__init__()
        self.register_buffer("scale", torch.ones(c))
        self.register_buffer("bias", torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def affine(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The fp32 (scale, shift) of ``x * scale + shift`` from the stored statistics."""
        root = torch.sqrt(self.var + BN_EPS)
        return self.scale / root, self.bias - self.mean * self.scale / root

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        count("bn_passes")
        scale, shift = self.affine()
        return x * scale.to(x.dtype).view(1, -1, 1, 1) + shift.to(x.dtype).view(1, -1, 1, 1)


class Bottleneck(nn.Module):
    n_convs = 3  # conv1..conv3 (and bn1..bn3), besides the downsample
    expansion = EXPANSION

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
        return _bottleneck_forward(self, x)


class BasicBlock(nn.Module):
    """torchvision BasicBlock (ResNet-18): two 3x3 convs, expansion 1."""

    n_convs = 2
    expansion = 1

    def __init__(self, cin: int, width: int, stride: int):
        super().__init__()
        self.conv1 = Conv2d(cin, width, 3, stride=stride, padding=1)
        self.bn1 = FrozenBatchNorm(width)
        self.conv2 = Conv2d(width, width, 3, padding=1)
        self.bn2 = FrozenBatchNorm(width)
        if stride != 1 or cin != width:
            self.downsample_conv = Conv2d(cin, width, 1, stride=stride)
            self.downsample_bn = FrozenBatchNorm(width)
        else:
            self.downsample_conv = None
            self.downsample_bn = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _basic_block_forward(self, x)


def _stem(in_channels: int, stem_kernel: int) -> Conv2d:
    """The 7x7/2 stem, or (``stem_kernel=4``) the space-to-depth stem's 4x4
    conv over ``in_channels`` = 4 x the image's channels."""
    if stem_kernel == 7:
        return Conv2d(in_channels, 64, 7, stride=2, padding=3)
    if stem_kernel == 4:
        return Conv2d(in_channels, 64, 4)  # geometry in stem_conv_apply
    raise ValueError(f"a stem kernel is 7x7 or (space-to-depth) 4x4, not {stem_kernel}")


def _add_layers(model: nn.Module, block_cls, layers) -> None:
    """layer1..layer4 of ``block_cls`` blocks after the 64-channel stem;
    each layer but the first starts at stride 2."""
    cin = 64
    for li, (blocks, width) in enumerate(zip(layers, RESNET50_WIDTHS)):
        stride = 1 if li == 0 else 2
        layer = []
        for bi in range(blocks):
            layer.append(block_cls(cin, width, stride if bi == 0 else 1))
            cin = width * block_cls.expansion
        setattr(model, f"layer{li + 1}", nn.ModuleList(layer))


class ResNet50(nn.Module):
    def __init__(self, in_channels: int = 3, stem_kernel: int = 7):
        super().__init__()
        self.conv1 = _stem(in_channels, stem_kernel)
        self.bn1 = FrozenBatchNorm(64)
        _add_layers(self, Bottleneck, RESNET50_LAYERS)


class ResNet18(nn.Module):
    """The reference's other trunk (``health_multimodal/image/model/
    resnet.py:63-71``); no dilation, as there (``model.py:211-213``)."""

    def __init__(self, in_channels: int = 3):
        super().__init__()
        self.conv1 = _stem(in_channels, 7)
        self.bn1 = FrozenBatchNorm(64)
        _add_layers(self, BasicBlock, RESNET18_LAYERS)


def conv_apply(conv: nn.Module, x: torch.Tensor, stride: Optional[int] = None,
               padding: Optional[int] = None, dilation: int = 1) -> torch.Tensor:
    """Apply one conv module, at its own stride and padding unless given.
    The forwards take this as a ``conv`` argument so another execution of
    the convs (the int8 path, ``ops/quant.py::conv_apply_int8``) reuses the
    block and layer structure."""
    return conv(x, stride=stride, padding=padding, dilation=dilation)


def fuses_epilogue(conv) -> bool:
    """Whether a forward with this conv hook hands its conv outputs to the
    kernel (:func:`bn_epilogue`'s ``fuse``): the default convs do; the int8
    convs (``ops/quant.py::conv_apply_int8``) keep the chain."""
    return conv is conv_apply


def bn_epilogue(out: torch.Tensor, bn: FrozenBatchNorm, relu: bool = True,
                residual: Optional[torch.Tensor] = None,
                residual_bn: Optional[FrozenBatchNorm] = None, fuse: bool = False) -> torch.Tensor:
    """A conv output's batch norm ``bn``, then an optional residual (a
    block's input, or with ``residual_bn`` the downsample conv's raw output
    and its batch norm), then an optional ReLU.

    ``fuse`` (the forwards pass :func:`fuses_epilogue` of their conv hook)
    lets a tensor the kernel takes (:func:`ops.conv_epilogue.applies`:
    CUDA bf16 ``channels_last``) get all of it in one pass of the kernel,
    in place over ``out``; anything else runs the chain of torch ops."""
    if fuse and conv_epilogue.applies(out, residual):
        scale, shift, residual_scale = conv_epilogue.bn_params(bn, residual_bn)
        return conv_epilogue.conv_epilogue_(out, scale, shift, residual, residual_scale, relu)
    y = bn(out)
    if residual is not None:
        y = y + (residual if residual_bn is None else residual_bn(residual))
    return torch.relu(y) if relu else y


def _basic_block_forward(block: BasicBlock, x: torch.Tensor, conv=conv_apply,
                         fuse: bool = False) -> torch.Tensor:
    out = bn_epilogue(conv(block.conv1, x), block.bn1, fuse=fuse)
    out = conv(block.conv2, out)
    if block.downsample_conv is None:
        return bn_epilogue(out, block.bn2, residual=x, fuse=fuse)
    return bn_epilogue(out, block.bn2, residual=conv(block.downsample_conv, x),
                       residual_bn=block.downsample_bn, fuse=fuse)


def _bottleneck_forward(block: Bottleneck, x: torch.Tensor, conv=conv_apply,
                        stride: Optional[int] = None, dilation: int = 1,
                        fuse: bool = False) -> torch.Tensor:
    """One bottleneck block; ``stride`` overrides the block's own (a dilated
    layer's first block runs at stride 1), and the 3x3 conv runs at
    ``dilation`` with as much padding.  Undilated, each conv is
    ``conv(module, x)``, so a hook that takes no overrides still serves.
    ``fuse``: see :func:`bn_epilogue`."""
    out = bn_epilogue(conv(block.conv1, x), block.bn1, fuse=fuse)
    if stride is None and dilation == 1:
        out = conv(block.conv2, out)
    else:
        out = conv(block.conv2, out, stride=stride, padding=dilation, dilation=dilation)
    out = conv(block.conv3, bn_epilogue(out, block.bn2, fuse=fuse))
    if block.downsample_conv is None:
        return bn_epilogue(out, block.bn3, residual=x, fuse=fuse)
    if stride is None:
        identity = conv(block.downsample_conv, x)
    else:
        identity = conv(block.downsample_conv, x, stride=stride)
    return bn_epilogue(out, block.bn3, residual=identity, residual_bn=block.downsample_bn,
                       fuse=fuse)


def space_to_depth_2x2(x_nhwc: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/2, W/2, 4C); channel index = (r%2)*2 + (c%2)
    blocks of C (the layout :func:`space_to_depth_stem_kernel` targets)."""
    b, h, w, c = x_nhwc.shape
    x = x_nhwc.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // 2, w // 2, 4 * c)


@torch.no_grad()
def space_to_depth_stem_kernel(kernel: torch.Tensor) -> torch.Tensor:
    """Rearrange the stem's (N, C, 7, 7) stride-2 OIHW kernel into the exact
    (N, 4C, 4, 4) stride-1 kernel over 2x2 space-to-depth input.

    The 7x7/2 conv reads rows 2*oi-3 .. 2*oi+3; in half-resolution
    coordinates r = 2*(oi - 2 + a) + pr those are a in 0..3 with parity pr
    in {0, 1}: a 4x4 window at offset -2..1 (padding (2, 1)).  Tap (a, pr)
    is row 2a + pr - 1 of the original kernel (out of range for a = pr = 0
    only: a structural zero); the same for columns.  The 49 taps are the
    same, so the math is exact."""
    n, c, kh, kw = kernel.shape
    if (kh, kw) != (7, 7):
        raise ValueError(f"expected a 7x7 stem kernel, got {tuple(kernel.shape)}")
    w4 = torch.zeros((n, 4 * c, 4, 4), dtype=kernel.dtype, device=kernel.device)
    for a in range(4):
        for pr in range(2):
            u = 2 * a + pr - 1
            if not 0 <= u <= 6:
                continue
            for b in range(4):
                for pc in range(2):
                    v = 2 * b + pc - 1
                    if not 0 <= v <= 6:
                        continue
                    ch = (pr * 2 + pc) * c
                    w4[:, ch:ch + c, a, b] = kernel[:, :, u, v]
    return w4


def is_space_to_depth_stem(conv: nn.Module) -> bool:
    w = getattr(conv, "weight", None)
    return w is not None and w.shape[-1] == 4


def stem_conv_apply(conv: nn.Module, x: torch.Tensor, conv_fn=conv_apply) -> torch.Tensor:
    """The stem conv, chosen by the kernel's shape: a (N, 4C, 4, 4) kernel
    (:func:`space_to_depth_stem_kernel`) runs the space-to-depth form,
    stride 1 with the asymmetric padding (2, 1) as an explicit ``F.pad``;
    otherwise the module's 7x7/2 conv through ``conv_fn``."""
    if not is_space_to_depth_stem(conv):
        return conv_fn(conv, x)
    xs = space_to_depth_2x2(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
    xs = F.pad(xs, (2, 1, 2, 1)).contiguous(memory_format=torch.channels_last)
    return conv(xs, stride=1, padding=0)


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """torch MaxPool2d(kernel=3, stride=2, padding=1); padding is -inf."""
    return F.max_pool2d(x, kernel_size=3, stride=2, padding=1)


def _to_nchw(x_nhwc: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x_nhwc.to(dtype).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def resnet50_forward(
    model: ResNet50,
    x_nhwc: torch.Tensor,
    dtype: torch.dtype = torch.float32,
    conv=conv_apply,
    layer1_fn=None,
    replace_stride_with_dilation: Sequence[bool] = (False, False, False),
) -> torch.Tensor:
    """(B, H, W, C) -> x4 (B, H/32, W/32, 2048), NHWC.

    ``conv(module, x, stride=, padding=, dilation=)`` applies each of the
    53 convolutions (default: the module itself;
    ``ops/quant.py::conv_apply_int8`` for the int8 trunk).  ``layer1_fn``,
    if given, replaces the whole stride-1 layer1 block chain (the hook for
    the fused kernel, ``ops/fused_bottleneck.py``); it takes and returns
    NHWC.  ``replace_stride_with_dilation`` follows torchvision for layers
    2-4 (the reference's ``reload_encoder_with_dilation`` uses (False,
    False, True)): the layer's stride becomes 1, its first block convolves
    at the previous dilation and the later blocks at the doubled one.
    """
    fuse = fuses_epilogue(conv)
    stem = stem_conv_apply(model.conv1, _to_nchw(x_nhwc, dtype), conv)
    out = max_pool_3x3_s2(bn_epilogue(stem, model.bn1, fuse=fuse))
    dilation = 1
    for li in range(4):
        if li == 0 and layer1_fn is not None:
            nhwc = out.permute(0, 2, 3, 1).contiguous()
            out = layer1_fn(nhwc).permute(0, 3, 1, 2)
            continue
        prev_dilation, stride = dilation, None
        if li > 0 and replace_stride_with_dilation[li - 1]:
            dilation, stride = dilation * 2, 1
        for bi, block in enumerate(getattr(model, f"layer{li + 1}")):
            if bi == 0:
                out = _bottleneck_forward(block, out, conv, stride=stride, dilation=prev_dilation,
                                          fuse=fuse)
            else:
                out = _bottleneck_forward(block, out, conv, dilation=dilation, fuse=fuse)
    return out.permute(0, 2, 3, 1)


def resnet18_forward(model: ResNet18, x_nhwc: torch.Tensor, dtype: torch.dtype = torch.float32,
                     conv=conv_apply) -> torch.Tensor:
    """(B, H, W, C) -> x4 (B, H/32, W/32, 512), NHWC (BasicBlocks)."""
    fuse = fuses_epilogue(conv)
    out = max_pool_3x3_s2(bn_epilogue(conv(model.conv1, _to_nchw(x_nhwc, dtype)), model.bn1,
                                      fuse=fuse))
    for li in range(4):
        for block in getattr(model, f"layer{li + 1}"):
            out = _basic_block_forward(block, out, conv, fuse=fuse)
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


def _init_convs(model: nn.Module, generator: Optional[torch.Generator]) -> nn.Module:
    generator = generator or torch.Generator().manual_seed(0)
    for m in model.modules():
        if isinstance(m, Conv2d):
            init_conv_(m, generator)
    return model.eval()


def init_resnet50(generator: Optional[torch.Generator] = None, in_channels: int = 3) -> ResNet50:
    """A ResNet-50 with seeded kaiming-normal convs and identity BN, on the CPU."""
    return _init_convs(ResNet50(in_channels), generator)


def init_resnet18(generator: Optional[torch.Generator] = None, in_channels: int = 3) -> ResNet18:
    """A ResNet-18 with seeded kaiming-normal convs and identity BN, on the CPU."""
    return _init_convs(ResNet18(in_channels), generator)
