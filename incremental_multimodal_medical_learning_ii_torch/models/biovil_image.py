"""BioViL image model: ResNet-50 trunk + 1x1-conv MLP projector.

Counterpart of the JAX package's ``models/biovil_image.py``.  The trunk's
x4 feature map goes through a 1x1-conv projector (Conv 2048->128 no-bias,
BN, ReLU, Conv 128->128 with bias) giving per-patch 128-d embeddings; the
global embedding is their mean over the grid, in fp32 and NOT
L2-normalised.  :func:`get_patchwise_projected_embeddings` gives the
patch grid the phrase-grounding engine uses (``model.py:160-174``),
optionally L2-normalised over the feature axis.
"""

from __future__ import annotations

import copy
from typing import NamedTuple, Optional

import torch
import torch.nn as nn

from incremental_multimodal_medical_learning_ii_torch.models.resnet import (
    Conv2d,
    FrozenBatchNorm,
    ResNet50,
    bn_epilogue,
    conv_apply,
    fuses_epilogue,
    init_conv_,
    init_resnet50,
    is_space_to_depth_stem,
    resnet50_forward,
    space_to_depth_stem_kernel,
)
from incremental_multimodal_medical_learning_ii_torch.utils.config import JOINT_FEATURE_SIZE

TRUNK_FEATURES = 2048


class ImageModelOutput(NamedTuple):
    projected_global_embedding: torch.Tensor  # (B, 128) fp32, raw (not normalised)
    projected_patch_embeddings: torch.Tensor  # (B, h, w, 128) fp32
    img_embedding: torch.Tensor  # (B, 2048) fp32 avg-pooled trunk features


class Projector(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = Conv2d(TRUNK_FEATURES, JOINT_FEATURE_SIZE, 1)
        self.bn = FrozenBatchNorm(JOINT_FEATURE_SIZE)
        self.conv2 = Conv2d(JOINT_FEATURE_SIZE, JOINT_FEATURE_SIZE, 1)
        self.conv2_bias = nn.Parameter(torch.zeros(JOINT_FEATURE_SIZE), requires_grad=False)


class BioViLImageModel(nn.Module):
    def __init__(self, encoder: Optional[ResNet50] = None):
        super().__init__()
        self.encoder = encoder if encoder is not None else ResNet50()
        self.projector = Projector()

    def forward(self, images_nhwc: torch.Tensor, dtype: torch.dtype = torch.float32,
                fused_layer1: bool = False) -> ImageModelOutput:
        return biovil_image_forward(self, images_nhwc, dtype=dtype, fused_layer1=fused_layer1)


def init_biovil_image_model(generator: Optional[torch.Generator] = None) -> BioViLImageModel:
    """Seeded random BioViL weights at the real architecture, on the CPU
    (kaiming-normal convs, identity BN, zero projector bias)."""
    generator = generator or torch.Generator().manual_seed(0)
    model = BioViLImageModel(init_resnet50(generator))
    init_conv_(model.projector.conv1, generator)
    init_conv_(model.projector.conv2, generator)
    return model.eval()


@torch.no_grad()
def fold_grayscale_conv1(model: BioViLImageModel) -> BioViLImageModel:
    """A copy of ``model`` whose stem takes single-channel input.

    The reference feeds three identical copies of the grayscale image, so
    ``conv1(repeat(x, 3), W) == conv1(x, sum_c W)``: summing the (64, 3, 7, 7)
    kernel over its input-channel axis keeps images (B, H, W, 1), a third
    of the traffic into conv1, with the same math (fp32 kernel sum).
    A space-to-depth stem's input channels are s2d blocks, not copies of
    one plane: fold before :func:`space_to_depth_stem`."""
    w = model.encoder.conv1.weight
    if w.shape[1] == 1:
        return model
    if is_space_to_depth_stem(model.encoder.conv1):
        if w.shape[1] == 4:
            return model  # folded before the space-to-depth transform
        raise ValueError("cannot grayscale-fold a 3-channel space-to-depth stem kernel; "
                         "apply fold_grayscale_conv1 BEFORE space_to_depth_stem")
    folded = copy.deepcopy(model)
    folded.encoder.conv1.weight = nn.Parameter(
        torch.sum(w.to(torch.float32), dim=1, keepdim=True), requires_grad=False
    )
    return folded


@torch.no_grad()
def space_to_depth_stem(model: BioViLImageModel) -> BioViLImageModel:
    """A copy of ``model`` whose stem is the exact space-to-depth form: a
    4x4 stride-1 conv over 2x2 space-to-depth input in place of the 7x7/2
    conv (``models/resnet.py::space_to_depth_stem_kernel``).  The forward
    chooses it from the kernel's shape.  Compose after
    :func:`fold_grayscale_conv1`."""
    conv1 = model.encoder.conv1
    if is_space_to_depth_stem(conv1):
        return model
    out = copy.deepcopy(model)
    w4 = space_to_depth_stem_kernel(conv1.weight.to(torch.float32))
    out.encoder.conv1 = Conv2d(w4.shape[1], w4.shape[0], 4).to(w4.device)
    out.encoder.conv1.weight.copy_(w4)
    return out


def quantize_biovil_int8(model: BioViLImageModel) -> BioViLImageModel:
    """A copy of ``model`` with the ResNet trunk quantized to int8
    (``ops/quant.py``); the 1x1-conv projector stays in float, as its
    output feeds the pooled embedding directly.  Use with
    ``biovil_image_forward(..., int8=True)``.  Refuses a model whose trunk
    is quantized already."""
    from incremental_multimodal_medical_learning_ii_torch.ops.quant import quantize_resnet_int8

    if is_space_to_depth_stem(model.encoder.conv1):
        # the int8 conv would run the 4x4 kernel with the 7x7/2 geometry
        raise ValueError("int8 quantization is incompatible with the space-to-depth stem; "
                         "quantize the standard model, or skip space_to_depth_stem")
    out = BioViLImageModel(quantize_resnet_int8(model.encoder))
    out.projector = copy.deepcopy(model.projector)
    return out.eval()


def _projector_forward(proj: Projector, patches_nchw: torch.Tensor,
                       fuse: bool = False) -> torch.Tensor:
    h = bn_epilogue(proj.conv1(patches_nchw), proj.bn, fuse=fuse)
    return proj.conv2(h) + proj.conv2_bias.to(h.dtype).view(1, -1, 1, 1)


def biovil_image_forward(
    model: BioViLImageModel,
    images_nhwc: torch.Tensor,
    dtype: torch.dtype = torch.float32,
    int8: bool = False,
    fused_layer1: bool = False,
) -> ImageModelOutput:
    """(B, H, W, C) float images in [0, 1] -> global + patch embeddings.

    ``fused_layer1=True`` runs layer1's 3-block chain through the fused
    kernel (``ops/fused_bottleneck.py``); it needs ``dtype=torch.bfloat16``
    and no gradients through layer1 (the kernel has no backward).  Layer1
    is folded once and kept with the model (refolded only after a change to
    its weights).  ``int8=True`` expects a model from
    :func:`quantize_biovil_int8` and runs the trunk's convs on int8 with
    int32 sums (``ops/quant.py``).  Mean/pool accumulations run in fp32
    under bf16 compute.
    """
    layer1_fn = None
    if fused_layer1:
        if int8:
            raise ValueError("fused_layer1 is incompatible with the int8 trunk")
        if dtype != torch.bfloat16:
            # the kernel computes in bf16 (fp32 accumulation); running it
            # inside an fp32 forward would silently downgrade layer1
            raise ValueError("fused_layer1 requires dtype=torch.bfloat16")
        from incremental_multimodal_medical_learning_ii_torch.ops.fused_bottleneck import (
            folded_layer,
            fused_bottleneck_layer,
        )

        folded = folded_layer(model.encoder.layer1)
        layer1_fn = lambda x: fused_bottleneck_layer(x, folded)  # noqa: E731
    conv = conv_apply
    if int8:
        from incremental_multimodal_medical_learning_ii_torch.ops.quant import conv_apply_int8

        conv = conv_apply_int8
    patches = resnet50_forward(model.encoder, images_nhwc, dtype=dtype, conv=conv,
                               layer1_fn=layer1_fn)
    projected = _projector_forward(model.projector, patches.permute(0, 3, 1, 2),
                                   fuse=fuses_epilogue(conv))
    projected32 = projected.to(torch.float32).permute(0, 2, 3, 1)
    global_emb = torch.mean(projected32, dim=(1, 2))
    pooled = torch.mean(patches.to(torch.float32), dim=(1, 2))
    return ImageModelOutput(
        projected_global_embedding=global_emb,
        projected_patch_embeddings=projected32,
        img_embedding=pooled,
    )


def get_patchwise_projected_embeddings(model: BioViLImageModel, images_nhwc: torch.Tensor,
                                       normalize: bool,
                                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, h, w, 128) fp32 patch embeddings, optionally L2-normalised over
    the feature axis (the norm clamped at 1e-12)."""
    patches = biovil_image_forward(model, images_nhwc, dtype=dtype).projected_patch_embeddings
    return normalize_patches(patches) if normalize else patches


def normalize_patches(patches: torch.Tensor) -> torch.Tensor:
    norm = torch.linalg.vector_norm(patches, dim=-1, keepdim=True)
    return patches / torch.clamp_min(norm, 1e-12)
