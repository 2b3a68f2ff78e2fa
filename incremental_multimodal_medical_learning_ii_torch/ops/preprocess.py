"""CXR preprocessing on the device: the BioViL pipeline as batched matmuls.

Counterpart of the JAX package's ``ops/preprocess.py`` (device path).  The
reference pipeline is ToPILImage -> Resize(size) -> CenterCrop(size) ->
ToTensor (/255) -> ExpandChannels (1->3).  The host builds a padded raw
uint8 buffer and PIL-parity resize matrices with the center crop folded
in (:class:`DevicePreprocessPlan`); the device does the resize as two
batched matmuls, uint8 rounding and /255.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from incremental_multimodal_medical_learning_ii_torch.ops.resize import (
    batched_matmul_resize,
    resize_matrix,
    resize_shape_for_smaller_edge,
)


def remap_to_uint8(array: np.ndarray, percentiles: Optional[Tuple[float, float]] = None) -> np.ndarray:
    """Min-max (or percentile-clipped) remap to [0, 255] uint8
    (``health_multimodal/image/data/io.py:16-47``)."""
    array = array.astype(float)
    if percentiles is not None:
        if len(percentiles) != 2:
            raise ValueError(
                "The value for percentiles should be a sequence of length 2,"
                f" but has length {len(percentiles)}"
            )
        a, b = percentiles
        if a >= b:
            raise ValueError(f'Percentiles must be in ascending order, but a sequence "{percentiles}" was passed')
        if a < 0 or b > 100:
            raise ValueError(f'Percentiles must be in the range [0, 100], but a sequence "{percentiles}" was passed')
        cutoff = np.percentile(array, percentiles)
        array = np.clip(array, *cutoff)
    array -= array.min()
    mx = array.max()
    if mx > 0:
        array /= mx
    array *= 255
    return array.astype(np.uint8)


def _effective_crop_start(out: int, crop: int) -> int:
    """Fused resize+crop row start for one dim, including torchvision's
    pad-when-smaller rule: CenterCrop first pads by floor((crop-out)/2) and
    crops at offset 0, so the content start is -((crop-out)//2)."""
    if out >= crop:
        return int(round((out - crop) / 2.0))
    return -((crop - out) // 2)


def _crop_rows(mat: np.ndarray, start: int, crop: int) -> np.ndarray:
    """Rows [start, start+crop) of the resize matrix, zero-padded where the
    crop extends past the resized image (CenterCrop pads with black)."""
    out = np.zeros((crop, mat.shape[1]), mat.dtype)
    src_lo = max(start, 0)
    src_hi = min(start + crop, mat.shape[0])
    dst_lo = src_lo - start
    out[dst_lo : dst_lo + (src_hi - src_lo)] = mat[src_lo:src_hi]
    return out


class DevicePreprocessPlan:
    """Host-side plan for a batch of raw images with heterogeneous sizes.

    Builds the padded raw buffer and per-shape PIL-parity resize matrices
    whose rows are the reference's Resize+CenterCrop output window.
    """

    # the eviction budget is in BYTES, not entries: entry size scales with
    # crop*pad_to, so an entry count alone would let shape-varied requests
    # to a long-lived server pin ~1 GB
    _MATRIX_CACHE_MAX = 256
    _MATRIX_CACHE_MAX_BYTES = 256 * 1024 * 1024

    def __init__(self, size: int = 512, crop: Optional[int] = None, pad_to: int = 1024):
        self.size = size
        self.crop = crop or size
        self.pad_to = pad_to
        self._matrix_cache: OrderedDict = OrderedDict()
        self._matrix_cache_bytes = 0

    def _matrices(self, h: int, w: int):
        """Cropped resize-matrix pair for one raw shape, LRU-cached per
        shape (the matrices are pure functions of (h, w, size, crop, pad_to))."""
        cached = self._matrix_cache
        pair = cached.get((h, w))
        if pair is not None:
            cached.move_to_end((h, w))
            return pair
        entry_bytes = 2 * self.crop * self.pad_to * 4  # the pair below
        while cached and (
            len(cached) >= self._MATRIX_CACHE_MAX
            or self._matrix_cache_bytes + entry_bytes > self._MATRIX_CACHE_MAX_BYTES
        ):
            _, old = cached.popitem(last=False)
            self._matrix_cache_bytes -= old[0].nbytes + old[1].nbytes
        out_h, out_w = resize_shape_for_smaller_edge(h, w, self.size)
        top = _effective_crop_start(out_h, self.crop)
        left = _effective_crop_start(out_w, self.crop)
        full_h = resize_matrix(h, out_h, padded_in=self.pad_to)
        full_w = resize_matrix(w, out_w, padded_in=self.pad_to)
        pair = cached[(h, w)] = (
            _crop_rows(full_h, top, self.crop),
            _crop_rows(full_w, left, self.crop),
        )
        self._matrix_cache_bytes += pair[0].nbytes + pair[1].nbytes
        return pair

    def prepare_deduped(self, images: Sequence[np.ndarray]):
        """images: list of (H, W) uint8 -> ``(raw (B,P,P) u8, uniq_w_h
        (U,crop,P), uniq_w_w (U,crop,P), idx (B,) i32)``: one matrix pair
        per DISTINCT image shape plus a per-image index.  ``U`` is padded to
        the next power of two (capped at B) with zero matrices, as the JAX
        package does to bound its recompiles."""
        b = len(images)
        p = self.pad_to
        raw = np.zeros((b, p, p), np.uint8)
        idx = np.zeros(b, np.int32)
        order: dict = {}
        for i, img in enumerate(images):
            h, w = img.shape
            if h > p or w > p:
                raise ValueError(f"image {i} ({h}x{w}) exceeds pad_to={p}")
            raw[i, :h, :w] = img
            key = (h, w)
            if key not in order:
                order[key] = len(order)
            idx[i] = order[key]
        u = len(order)
        u_pad = 1
        while u_pad < u:
            u_pad *= 2
        u_pad = min(u_pad, b)
        uniq_w_h = np.zeros((u_pad, self.crop, p), np.float32)
        uniq_w_w = np.zeros((u_pad, self.crop, p), np.float32)
        for (h, w), j in order.items():
            uniq_w_h[j], uniq_w_w[j] = self._matrices(h, w)
        return raw, uniq_w_h, uniq_w_w, idx


def _normalize_and_expand(resized: torch.Tensor, channels: int) -> torch.Tensor:
    """ToTensor (/255) + optional ExpandChannels."""
    out = (resized / 255.0)[..., None]
    if channels == 1:
        return out
    return out.expand(*out.shape[:3], channels)


def preprocess_device(
    raw: torch.Tensor, w_h: torch.Tensor, w_w: torch.Tensor, channels: int = 3
) -> torch.Tensor:
    """(B, P, P) u8 + per-image weights -> (B, crop, crop, C) float32 [0,1].
    ``channels=1`` keeps the grayscale plane for the folded-conv1 encoder
    (:func:`models.biovil_image.fold_grayscale_conv1`)."""
    resized = batched_matmul_resize(raw, w_h, w_w, round_uint8=True)
    return _normalize_and_expand(resized, channels)


def preprocess_device_indexed(
    raw: torch.Tensor,
    uniq_w_h: torch.Tensor,
    uniq_w_w: torch.Tensor,
    idx: torch.Tensor,
    channels: int = 3,
) -> torch.Tensor:
    """(B,P,P) u8 + (U,crop,P) unique weights + (B,) index -> preprocessed
    batch; the per-image matrices are gathered on the device."""
    idx = idx.long()
    return preprocess_device(raw, uniq_w_h[idx], uniq_w_w[idx], channels=channels)
