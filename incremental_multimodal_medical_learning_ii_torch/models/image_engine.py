"""Single-image inference engine (counterpart of the JAX package's
``models/image_engine.py``).

Capability parity with ``health_multimodal/image/inference_engine.py``:
load one CXR from disk (JPEG/PNG/DICOM/NIfTI with percentile remap), apply
the resize/center-crop pipeline on the host, and return

* :meth:`get_projected_global_embedding`: the L2-normalised (128,)
  embedding (``inference_engine.py:69-87``; the extraction pass stores raw
  embeddings, ``engine/extract.py``);
* :meth:`get_projected_patch_embeddings`: the (h, w, 128) L2-normalised
  patch grid and the original (width, height) (``:59-67``).

Default geometry is the vendored factory's: resize 512, crop 480
(``image/utils.py:11-12``).  The model runs on CUDA unless
``device="cpu"``; ``dtype=torch.bfloat16`` opts into bf16 convolutions
(fp32 by default, as in JAX).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from incremental_multimodal_medical_learning_ii_torch.models.biovil_image import (
    BioViLImageModel,
    biovil_image_forward,
    normalize_patches,
)
from incremental_multimodal_medical_learning_ii_torch.ops.preprocess import preprocess_host
from incremental_multimodal_medical_learning_ii_torch.utils.device import resolve_device, upload

TRANSFORM_RESIZE = 512
TRANSFORM_CENTER_CROP_SIZE = 480


class ImageInferenceEngine:
    def __init__(self, model: BioViLImageModel, resize_size: int = TRANSFORM_RESIZE,
                 crop_size: int = TRANSFORM_CENTER_CROP_SIZE,
                 dtype: Optional[torch.dtype] = None, device=None):
        """``model`` is moved to the device."""
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.resize_size = resize_size
        self.crop_size = crop_size
        self.dtype = dtype or torch.float32

    def load_and_transform_input_image(self, image_path) -> Tuple[np.ndarray, Tuple[int, int]]:
        """(1, crop, crop, 3) float32 in [0, 1] and the original (width, height)."""
        from incremental_multimodal_medical_learning_ii_torch.data.images import load_image

        raw = load_image(image_path)
        pre = preprocess_host(raw, size=self.resize_size, crop=self.crop_size)
        return pre[None], (raw.shape[1], raw.shape[0])

    @torch.no_grad()
    def embed(self, image: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
        """One forward of a preprocessed (1, crop, crop, 3) image: the raw
        global embedding (128,) and the normalised patches (h, w, 128),
        fp32 on the device."""
        out = biovil_image_forward(self.model, upload(image, self.device), dtype=self.dtype)
        return out.projected_global_embedding[0], normalize_patches(out.projected_patch_embeddings)[0]

    def get_projected_global_embedding(self, image_path) -> np.ndarray:
        img, _ = self.load_and_transform_input_image(image_path)
        emb = self.embed(img)[0].cpu().numpy()
        return emb / max(np.linalg.norm(emb), 1e-12)

    def get_projected_patch_embeddings(self, image_path) -> Tuple[np.ndarray, Tuple[int, int]]:
        img, size = self.load_and_transform_input_image(image_path)
        return self.embed(img)[1].cpu().numpy(), size
