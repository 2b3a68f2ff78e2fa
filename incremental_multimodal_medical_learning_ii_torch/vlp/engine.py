"""Joint image-text (VLP) inference: similarity scores and phrase grounding
(counterpart of the JAX package's ``vlp/engine.py``).

Capability parity with ``health_multimodal/vlp/inference_engine.py``:

* :meth:`ImageTextInferenceEngine.get_similarity_score_from_raw_data`
  (``:30-57``): cosine between the image's global embedding
  (L2-normalised) and the mean text embedding of the query prompts (mean
  of raw embeddings, then L2-normalised);
* :meth:`ImageTextInferenceEngine.get_similarity_map_from_raw_data`
  (``:59-91``): patch-embedding x text-embedding similarity grid,
  gaussian-smoothed (sigma 1.5), resized back to the original image
  geometry with NaN outside the crop (``:94-155``).

The similarity and the smoothing run on the model's device; the geometric
re-mapping is host numpy (a per-image visualisation, not a training
tensor).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

FIGURE_NOT_PORTED = ("not yet ported: the phrase-grounding figure needs matplotlib, which the "
                     "card's machine lacks (ROADMAP Queue 1, item 9)")


def _gaussian_kernel_1d(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """scipy.ndimage.gaussian_filter's kernel (radius = truncate * sigma)."""
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_smooth_2d(grid: torch.Tensor, sigma: float = 1.5) -> torch.Tensor:
    """Separable gaussian blur of an (h, w) grid matching
    ``scipy.ndimage.gaussian_filter``'s default boundary: scipy's 'reflect'
    repeats the edge sample, which is numpy's 'symmetric' (torch's
    ``F.pad(mode="reflect")`` is numpy's 'reflect', which does not).  The
    padded samples are gathered through ``np.pad(arange(n), r, "symmetric")``,
    which stays right when the radius exceeds the grid (6 at sigma 1.5
    against a 2x2 grid: the padding reflects again and again)."""
    k = torch.from_numpy(_gaussian_kernel_1d(sigma)).to(grid.device)
    r = (len(k) - 1) // 2

    def smooth_last(x: torch.Tensor) -> torch.Tensor:
        idx = torch.from_numpy(np.pad(np.arange(x.shape[-1]), r, mode="symmetric")).to(x.device)
        windows = x[..., idx].unfold(-1, len(k), 1)  # (..., n, 2r + 1)
        return (windows * k).sum(-1)

    return smooth_last(smooth_last(grid.T).T)


class ImageTextInferenceEngine:
    def __init__(self, image_model, text_engine, resize_size: int = 512, crop_size: int = 480,
                 dtype: Optional[torch.dtype] = None, device=None):
        """``image_model``: a ``BioViLImageModel``, run through a
        :class:`models.image_engine.ImageInferenceEngine` (one preprocessing
        contract and the engine's ``dtype`` knob: fp32 by default,
        ``torch.bfloat16`` opt-in); ``text_engine``: a
        :class:`text.engine.TextInferenceEngine` (or anything with its
        ``get_embeddings_from_prompt``).  Default geometry is the vendored
        engine factory's (``image/utils.py:11-12``: resize 512, crop 480)."""
        from incremental_multimodal_medical_learning_ii_torch.models.image_engine import (
            ImageInferenceEngine,
        )

        self.image_engine = ImageInferenceEngine(image_model, resize_size=resize_size,
                                                 crop_size=crop_size, dtype=dtype, device=device)
        self.device = self.image_engine.device
        self.text_engine = text_engine
        self.resize_size = resize_size
        self.crop_size = crop_size

    def _load(self, image_path) -> Tuple[np.ndarray, Tuple[int, int]]:
        return self.image_engine.load_and_transform_input_image(image_path)

    def get_similarity_score_from_raw_data(self, image_path,
                                           query_text: Union[str, List[str]]) -> float:
        query = [query_text] if isinstance(query_text, str) else list(query_text)
        img, _ = self._load(image_path)
        img_emb = _unit(self.image_engine.embed(img)[0].cpu().numpy())
        txt = self.text_engine.get_embeddings_from_prompt(query, normalize=False).mean(axis=0)
        return float(img_emb @ _unit(txt))

    def get_similarity_map_from_raw_data(self, image_path, query_text: str,
                                         interpolation: str = "nearest") -> np.ndarray:
        if not isinstance(query_text, str):
            raise TypeError("the similarity map takes one query string")
        img, size_wh = self._load(image_path)
        txt = self.text_engine.get_embeddings_from_prompt([query_text], normalize=True)[0]
        patches = self.image_engine.embed(img)[1]
        return self._map_from(patches, size_wh, txt, interpolation)

    @torch.no_grad()
    def _map_from(self, patches: torch.Tensor, size_wh, txt_norm: np.ndarray,
                  interpolation: str = "nearest") -> np.ndarray:
        txt = torch.from_numpy(np.asarray(txt_norm, np.float32)).to(patches.device)
        sim = torch.einsum("hwd,d->hw", patches, txt)
        smoothed = gaussian_smooth_2d(sim, sigma=1.5).cpu().numpy()
        width, height = size_wh
        return convert_similarity_to_image_size(smoothed, width, height, self.resize_size,
                                                self.crop_size, interpolation)

    def get_score_and_map_from_raw_data(self, image_path, query_text: str,
                                        interpolation: str = "nearest"):
        """(global similarity score, grounding map) from one image load and
        preprocess, one image forward and one text encode (the two separate
        raw-data methods each pay those again)."""
        if not isinstance(query_text, str):
            raise TypeError("the similarity map takes one query string")
        img, size_wh = self._load(image_path)
        global_emb, patches = self.image_engine.embed(img)
        txt = _unit(self.text_engine.get_embeddings_from_prompt([query_text], normalize=False)[0])
        score = float(_unit(global_emb.cpu().numpy()) @ txt)
        return score, self._map_from(patches, size_wh, txt, interpolation)


def _unit(v: np.ndarray) -> np.ndarray:
    return v / max(np.linalg.norm(v), 1e-12)


def convert_similarity_to_image_size(
    similarity_map: np.ndarray,
    width: int,
    height: int,
    resize_size: Optional[int],
    crop_size: Optional[int],
    interpolation: str = "nearest",
) -> np.ndarray:
    """Map the patch-grid similarity back onto the original image geometry,
    NaN-padding the region outside the center crop (``vlp:121-155``)."""
    smallest = min(width, height)
    if crop_size is not None:
        if resize_size is not None:
            target = int(crop_size * smallest / resize_size)
        else:
            target = crop_size
        upsized = _interpolate(similarity_map, (target, target), interpolation)
        out = np.full((height, width), np.nan, np.float32)
        margin_w, margin_h = width - target, height - target
        top, left = math.floor(margin_h / 2), math.floor(margin_w / 2)
        # negative margins (target larger than the image side, e.g.
        # crop_size > dim with resize_size=None) reproduce the reference's
        # negative F.pad: CROP floor(|margin|/2) off the near side and
        # ceil(|margin|/2) off the far side, instead of a wrapped slice
        src_top, dst_top = max(0, -top), max(0, top)
        src_left, dst_left = max(0, -left), max(0, left)
        h_span = min(target - src_top, height - dst_top)
        w_span = min(target - src_left, width - dst_left)
        out[dst_top : dst_top + h_span, dst_left : dst_left + w_span] = (
            upsized[src_top : src_top + h_span, src_left : src_left + w_span]
        )
        return out
    return _interpolate(similarity_map, (height, width), interpolation)


def _interpolate(grid: np.ndarray, size: Tuple[int, int], mode: str) -> np.ndarray:
    if mode == "nearest":
        # torch F.interpolate(mode='nearest') convention (the reference,
        # vlp/inference_engine.py:139-144): src = floor(dst * in / out)
        h_idx = (np.arange(size[0]) * grid.shape[0] // size[0]).astype(np.intp)
        w_idx = (np.arange(size[1]) * grid.shape[1] // size[1]).astype(np.intp)
        return np.asarray(grid)[np.ix_(h_idx, w_idx)]
    if mode in ("bilinear", "linear"):
        # half-pixel centres and no antialiasing, also when the target is
        # smaller than the patch grid (the JAX package's
        # jax.image.resize(antialias=False))
        t = torch.from_numpy(np.ascontiguousarray(grid, np.float32))[None, None]
        out = F.interpolate(t, size=tuple(size), mode="bilinear", align_corners=False,
                            antialias=False)
        return out[0, 0].numpy()
    raise ValueError(f"unsupported interpolation {mode!r}")


def plot_phrase_grounding_similarity_map(image_path, similarity_map: np.ndarray):
    """The three-panel figure (input, isolines, heatmap overlay): not yet
    ported."""
    raise NotImplementedError(FIGURE_NOT_PORTED)
