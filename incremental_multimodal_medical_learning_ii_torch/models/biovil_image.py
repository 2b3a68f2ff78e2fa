"""BioViL image model: ResNet-50 trunk + 1x1-conv MLP projector.

Counterpart of the JAX package's ``models/biovil_image.py``.  The trunk's
x4 feature map goes through a 1x1-conv projector (Conv 2048->128 no-bias,
BN, ReLU, Conv 128->128 with bias) giving per-patch 128-d embeddings; the
global embedding is their mean over the grid, in fp32 and NOT
L2-normalised.
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
    init_conv_,
    init_resnet50,
    resnet50_forward,
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
    of the traffic into conv1, with the same math (fp32 kernel sum)."""
    w = model.encoder.conv1.weight
    if w.shape[1] == 1:
        return model
    folded = copy.deepcopy(model)
    folded.encoder.conv1.weight = nn.Parameter(
        torch.sum(w.to(torch.float32), dim=1, keepdim=True), requires_grad=False
    )
    return folded


def _projector_forward(proj: Projector, patches_nchw: torch.Tensor) -> torch.Tensor:
    h = torch.relu(proj.bn(proj.conv1(patches_nchw)))
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
    its weights).  Mean/pool
    accumulations run in fp32 under bf16 compute.  The int8 trunk of the
    JAX package is not ported yet.
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
    if int8:
        raise NotImplementedError("the int8 trunk is not yet ported to the PyTorch package")
    patches = resnet50_forward(model.encoder, images_nhwc, dtype=dtype, layer1_fn=layer1_fn)
    projected = _projector_forward(model.projector, patches.permute(0, 3, 1, 2))
    projected32 = projected.to(torch.float32).permute(0, 2, 3, 1)
    global_emb = torch.mean(projected32, dim=(1, 2))
    pooled = torch.mean(patches.to(torch.float32), dim=(1, 2))
    return ImageModelOutput(
        projected_global_embedding=global_emb,
        projected_patch_embeddings=projected32,
        img_embedding=pooled,
    )
