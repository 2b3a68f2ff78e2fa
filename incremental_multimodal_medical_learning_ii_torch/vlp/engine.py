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
tensor).  :func:`plot_phrase_grounding_similarity_map` draws the vendored
three-panel figure with PIL (``evaluation/plots.py``), its isolines by
marching squares (:func:`isolines`).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

ISOLINE_LEVELS = (0.25, 0.5, 0.75, 1.0)  # np.linspace(0.25, 1, 4)


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


def isolines(z: np.ndarray, level: float) -> np.ndarray:
    """Marching squares: the (k, 4) segments ``(x0, y0, x1, y1)`` (column,
    row coordinates of ``z``) where ``z`` crosses ``level``, linear along
    each cell edge; a cell with a NaN corner draws nothing, and a saddle
    cell is split by its centre's side of the level."""
    z = np.asarray(z, np.float64)
    a, b = z[:-1, :-1], z[:-1, 1:]  # top-left, top-right
    d, c = z[1:, :-1], z[1:, 1:]  # bottom-left, bottom-right
    ok = np.isfinite(a) & np.isfinite(b) & np.isfinite(c) & np.isfinite(d)
    rows, cols = np.meshgrid(np.arange(a.shape[0], dtype=np.float64),
                             np.arange(a.shape[1], dtype=np.float64), indexing="ij")

    def cross(p, q):  # fraction along the edge p -> q where z meets the level
        with np.errstate(invalid="ignore", divide="ignore"):
            return np.clip((level - p) / (q - p), 0.0, 1.0)

    # the crossing point on each edge: top, right, bottom, left
    points = [
        (cols + cross(a, b), rows),
        (cols + 1.0, rows + cross(b, c)),
        (cols + cross(d, c), rows + 1.0),
        (cols, rows + cross(a, d)),
    ]
    above = [p >= level for p in (a, b, c, d)]
    crossed = [above[0] != above[1], above[1] != above[2], above[3] != above[2],
               above[0] != above[3]]
    n_crossed = sum(e.astype(np.int8) for e in crossed)
    segments = []

    def add(mask, e0, e1):
        if mask.any():
            segments.append(np.stack([points[e0][0][mask], points[e0][1][mask],
                                      points[e1][0][mask], points[e1][1][mask]], axis=1))

    two = ok & (n_crossed == 2)
    for e0 in range(4):
        for e1 in range(e0 + 1, 4):
            add(two & crossed[e0] & crossed[e1], e0, e1)
    saddle = ok & (n_crossed == 4)
    centre_like_a = ((a + b + c + d) / 4.0 >= level) == above[0]
    add(saddle & centre_like_a, 0, 1)  # b and d cut off alone
    add(saddle & centre_like_a, 2, 3)
    add(saddle & ~centre_like_a, 0, 3)  # a and c cut off alone
    add(saddle & ~centre_like_a, 1, 2)
    return np.concatenate(segments) if segments else np.zeros((0, 4))


def plot_phrase_grounding_similarity_map(image_path, similarity_map: np.ndarray):
    """Three-panel figure on a 1500x600 canvas: the input image in grey,
    the isolines at 0.25, 0.5, 0.75 and 1.0 coloured by RdBu_r over
    [-1, 1] with their levels written beside them, and the map over the
    image at alpha 0.5 (NaN transparent) with a colour bar, as the
    vendored visualisation draws them (``common/visualization.py:36-120``).
    A flat or empty map draws no isolines.  Returns an
    ``evaluation.plots.Figure``."""
    from PIL import Image

    from incremental_multimodal_medical_learning_ii_torch.data.images import load_image
    from incremental_multimodal_medical_learning_ii_torch.evaluation.plots import (
        Canvas,
        Figure,
        colormap,
    )

    img = np.asarray(load_image(image_path), np.float64)
    sim = np.asarray(similarity_map, np.float64)
    lo, hi = float(img.min()), float(img.max())
    grey = np.round((img - lo) / (hi - lo if hi > lo else 1.0) * 255.0).astype(np.uint8)
    cv = Canvas(1500, 600)
    h, w = grey.shape
    scale = min(380.0 / w, 480.0 / h)
    pw, ph = max(1, round(w * scale)), max(1, round(h * scale))
    base = Image.fromarray(grey, "L").convert("RGB").resize((pw, ph), Image.BILINEAR)
    finite = np.isfinite(sim)
    lines = {}
    for k, title in enumerate(("Input image", "Similarity isolines", "Similarity heatmap")):
        x0 = round(75 + k * 480 + (380 - pw) / 2)
        y0 = round(60 + (480 - ph) / 2)
        panel = base.copy()
        if k == 2:
            rgba = np.zeros(sim.shape + (4,), np.uint8)
            rgba[..., :3] = colormap("RdBu_r", sim, -1.0, 1.0)
            rgba[..., 3] = np.where(finite, 128, 0)
            overlay = Image.fromarray(rgba, "RGBA").resize((pw, ph), Image.NEAREST)
            panel = Image.alpha_composite(panel.convert("RGBA"), overlay).convert("RGB")
        cv.image.paste(panel, (x0, y0))
        cv.title((x0 + pw / 2, y0 - 6), title)
        if k == 1:
            sx, sy = pw / sim.shape[1], ph / sim.shape[0]
            for level in ISOLINE_LEVELS:
                segs = isolines(sim, level)
                lines[level] = segs
                if not len(segs):
                    continue
                color = tuple(int(v) for v in colormap("RdBu_r", level, -1.0, 1.0))
                for xa, ya, xb, yb in segs:
                    cv.draw.line([(x0 + (xa + 0.5) * sx, y0 + (ya + 0.5) * sy),
                                  (x0 + (xb + 0.5) * sx, y0 + (yb + 0.5) * sy)], fill=color, width=2)
                xa, ya, xb, yb = segs[len(segs) // 2]
                cv.text((x0 + ((xa + xb) / 2 + 0.5) * sx, y0 + ((ya + yb) / 2 + 0.5) * sy),
                        f"{level:.2f}", color=color)
        if k == 2:
            cv.colorbar((x0 + pw + 14, y0, x0 + pw + 28, y0 + ph), "RdBu_r", -1.0, 1.0)
    return Figure("grounding", dict(image=grey, similarity_map=sim, levels=ISOLINE_LEVELS,
                                    isolines=lines, vmin=-1.0, vmax=1.0, alpha=0.5), cv.image)
