"""End-to-end CheXpert classifier for serving (counterpart of the JAX
package's ``inference.py``).

Raw CXR images -> preprocess on the device (resize + crop as two batched
matmuls) -> frozen BioViL ResNet-50 (grayscale-folded stem, optional fused
layer1 kernel) -> optional trained image adapter -> prompt-cosine scores
against the (optionally text-adapted) prompt bank, through the fused
cosine kernel.  Batches are padded to a static ``batch_size`` by repeating
the last image, as the JAX package does.  Semantics follow the reference's
``Trainer.py:1016-1047`` (scores, argmax predictions).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from incremental_multimodal_medical_learning_ii_torch.models.adapters import AdapterPair
from incremental_multimodal_medical_learning_ii_torch.models.biovil_image import (
    BioViLImageModel,
    biovil_image_forward,
    fold_grayscale_conv1,
)
from incremental_multimodal_medical_learning_ii_torch.objectives.scorer import (
    PromptBank,
    apply_text_adapter_to_bank,
    score_embeddings,
)
from incremental_multimodal_medical_learning_ii_torch.ops.preprocess import (
    DevicePreprocessPlan,
    preprocess_device_indexed,
)
from incremental_multimodal_medical_learning_ii_torch.utils.config import (
    CHEXPERT_COMPETITION_TASKS,
    ExperimentConfig,
)
from incremental_multimodal_medical_learning_ii_torch.utils.device import resolve_device
from incremental_multimodal_medical_learning_ii_torch.utils.retry import retry_call


class ChexpertClassifier:
    """Batched raw-image -> 5-way score/prediction service.

    ``device=None`` means CUDA (raises on a host without it); pass
    ``device="cpu"`` for the plain PyTorch path.  The scoring contraction
    always goes through :func:`ops.fused_cosine.fused_pairwise_cosine`,
    which launches the CUDA kernel on the card; ``fused_layer1=True``
    (bf16 only) runs layer1 through the fused bottleneck kernel.
    """

    def __init__(
        self,
        image_params: BioViLImageModel,
        bank: PromptBank,
        cfg: Optional[ExperimentConfig] = None,
        adapter_params: Optional[nn.ModuleDict] = None,
        batch_size: int = 16,
        size: int = 512,
        crop: Optional[int] = None,
        pad_to: int = 1024,
        dtype: torch.dtype = torch.bfloat16,
        retries: int = 2,
        retry_backoff_s: float = 0.25,
        fused_layer1: bool = False,
        device=None,
    ):
        self.device = resolve_device(device)
        self.retries = retries
        self.retry_backoff_s = retry_backoff_s
        if cfg is None and adapter_params:
            # a no-head default would never APPLY the given adapters
            raise ValueError(
                "adapter_params given without a cfg enabling an adapter — "
                "pass the ExperimentConfig the adapters were trained under"
            )
        self.cfg = cfg or ExperimentConfig(
            adapter="no-head", image_adapter=False, text_adapter=False
        )
        self.pair = AdapterPair(
            kind=self.cfg.adapter,
            shared=self.cfg.shared,
            use_image=self.cfg.image_adapter,
            use_text=self.cfg.text_adapter,
        )
        self.adapter_params = (adapter_params or nn.ModuleDict()).to(self.device).eval()
        self.bank = bank.to(self.device)
        self.batch_size = batch_size
        self.dtype = dtype
        self.fused_layer1 = fused_layer1
        self.plan = DevicePreprocessPlan(size=size, crop=crop, pad_to=pad_to)
        self.class_names = list(CHEXPERT_COMPETITION_TASKS)
        # single-channel images + folded conv1: the same math, a third of
        # the image traffic (models/biovil_image.py::fold_grayscale_conv1)
        self.image_params = fold_grayscale_conv1(image_params).to(self.device).eval()
        self._fn = self._forward

    @torch.no_grad()
    def _forward(self, raw, w_h, w_w, idx):
        """One padded batch on the device -> (embs, scores, preds)."""
        images = preprocess_device_indexed(raw, w_h, w_w, idx, channels=1)
        embs = biovil_image_forward(
            self.image_params, images, dtype=self.dtype, fused_layer1=self.fused_layer1
        ).projected_global_embedding
        x = self.pair.apply_image(self.adapter_params, embs)
        bank = (
            apply_text_adapter_to_bank(self.pair.apply_text, self.adapter_params, self.bank)
            if self.pair.use_text
            else self.bank
        )
        out = score_embeddings(
            x, bank, self.cfg.prompt_mode, self.cfg.train_logit_diff,
            self.cfg.pred_logit_diff, use_kernel=True,
        )
        return x, out.scores, out.preds

    def _run(self, images: Sequence[np.ndarray]):
        embs_all: List[np.ndarray] = []
        scores_all: List[np.ndarray] = []
        preds_all: List[np.ndarray] = []
        for start in range(0, len(images), self.batch_size):
            chunk = list(images[start : start + self.batch_size])
            n = len(chunk)
            while len(chunk) < self.batch_size:  # static shapes
                chunk.append(chunk[-1])
            raw, w_h, w_w, idx = self.plan.prepare_deduped(chunk)
            embs, scores, preds = self._dispatch_with_retry(raw, w_h, w_w, idx)
            embs_all.append(embs[:n])
            scores_all.append(scores[:n])
            preds_all.append(preds[:n])
        return np.concatenate(embs_all), np.concatenate(scores_all), np.concatenate(preds_all)

    def predict_arrays(self, images: Sequence[np.ndarray]):
        """images: list of (H, W) uint8 -> (scores (N, 5), preds (N, 5)) float32."""
        if not images:
            n_cls = len(self.class_names)
            return np.empty((0, n_cls), np.float32), np.empty((0, n_cls), np.float32)
        _, scores, preds = self._run(images)
        return scores, preds

    def embed_arrays(self, images: Sequence[np.ndarray]) -> np.ndarray:
        """images -> (N, 128) float32 embeddings as scored: the global image
        embedding after the image adapter."""
        if not images:
            return np.empty((0, 128), np.float32)
        return self._run(images)[0]

    def _dispatch_with_retry(self, raw, w_h, w_w, idx):
        """One device dispatch + readback, re-dispatched on transient
        backend errors (utils/retry.py)."""
        dev = self.device

        def attempt():
            outs = self._fn(
                torch.from_numpy(raw).to(dev), torch.from_numpy(w_h).to(dev),
                torch.from_numpy(w_w).to(dev), torch.from_numpy(idx).to(dev),
            )
            return tuple(o.cpu().numpy() for o in outs)

        return retry_call(attempt, self.retries, self.retry_backoff_s)

    def predict_paths(self, paths: Sequence[str]):
        from incremental_multimodal_medical_learning_ii_torch.data.images import (
            load_image_raw_uint8,
        )

        return self.predict_arrays([load_image_raw_uint8(p) for p in paths])
