"""CXR preprocessing: the BioViL pipeline on the host (PIL) and on the
device (batched matmuls).

Counterpart of the JAX package's ``ops/preprocess.py``.  The reference
pipeline is ToPILImage -> Resize(size) -> CenterCrop(size) -> ToTensor
(/255) -> ExpandChannels (1->3).

* :func:`preprocess_host` runs it with PIL, for ``--host-preprocess``;
* the device paths take raw uint8 pixels and PIL-parity resize matrices
  with the center crop folded in, built on the host: one pair per distinct
  shape with a per-image index (:class:`DevicePreprocessPlan`,
  :func:`preprocess_device_indexed`), or one pair for a batch of one shape
  (:class:`SharedSizePreprocessPlan`, :func:`preprocess_device_shared`);
  the device does the resize as two matmuls, uint8 rounding and /255.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from incremental_multimodal_medical_learning_ii_torch.data.images import (  # noqa: F401
    remap_to_uint8,  # kept here too, where the JAX package has it
)
from incremental_multimodal_medical_learning_ii_torch.ops.resize import (
    apply_uint8_rounding,
    batched_matmul_resize,
    resize_matrix,
    resize_shape_for_smaller_edge,
)


def center_crop_bounds(h: int, w: int, crop: int) -> Tuple[int, int]:
    """torchvision CenterCrop corner: int(round((dim - crop) / 2))."""
    top = int(round((h - crop) / 2.0))
    left = int(round((w - crop) / 2.0))
    return top, left


def preprocess_host(image_u8: np.ndarray, size: int = 512, crop: Optional[int] = None) -> np.ndarray:
    """(H, W) uint8 -> (crop, crop, 3) float32 in [0,1]; the reference
    pipeline itself via PIL (Resize smaller edge -> CenterCrop -> /255 ->
    3ch).  PIL is imported here, so the device paths never need it."""
    from PIL import Image

    crop = crop or size
    pil = Image.fromarray(image_u8, mode="L")
    h, w = image_u8.shape
    out_h, out_w = resize_shape_for_smaller_edge(h, w, size)
    pil = pil.resize((out_w, out_h), Image.BILINEAR)
    arr = np.asarray(pil)
    top, left = center_crop_bounds(out_h, out_w, crop)
    if top < 0 or left < 0 or out_h < crop or out_w < crop:  # pad if smaller
        padded = np.zeros((max(out_h, crop), max(out_w, crop)), np.uint8)
        py, px = (padded.shape[0] - out_h) // 2, (padded.shape[1] - out_w) // 2
        padded[py : py + out_h, px : px + out_w] = arr
        arr = padded
        top, left = center_crop_bounds(arr.shape[0], arr.shape[1], crop)
    arr = arr[top : top + crop, left : left + crop]
    out = (arr.astype(np.float32) / 255.0)[..., None]
    return np.repeat(out, 3, axis=-1)


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

    def prepare(self, images: Sequence[np.ndarray]):
        """images: list of (H, W) uint8 -> ``(raw (B,P,P) u8, w_h
        (B,crop,P), w_w (B,crop,P))``, one matrix pair per image, the
        operands of :func:`preprocess_device`.  CenterCrop is fused into the
        matrices (rows outside the crop are left out), so the device output
        is (B, crop, crop) straight away."""
        b = len(images)
        p = self.pad_to
        raw = np.zeros((b, p, p), np.uint8)
        w_h = np.zeros((b, self.crop, p), np.float32)
        w_w = np.zeros((b, self.crop, p), np.float32)
        for i, img in enumerate(images):
            h, w = img.shape
            if h > p or w > p:
                raise ValueError(f"image {i} ({h}x{w}) exceeds pad_to={p}")
            raw[i, :h, :w] = img
            w_h[i], w_w[i] = self._matrices(h, w)
        return raw, w_h, w_w

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


class SharedSizePreprocessPlan:
    """Uniform-size batches (CheXpert-small is mostly one geometry): one
    weight-matrix pair shared by the whole batch, so only the raw uint8
    pixels cross to the device with each batch."""

    def __init__(self, height: int, width: int, size: int = 512, crop: Optional[int] = None):
        self.height, self.width = height, width
        self.size = size
        self.crop = crop or size
        out_h, out_w = resize_shape_for_smaller_edge(height, width, size)
        top = _effective_crop_start(out_h, self.crop)
        left = _effective_crop_start(out_w, self.crop)
        self.w_h = _crop_rows(resize_matrix(height, out_h), top, self.crop)
        self.w_w = _crop_rows(resize_matrix(width, out_w), left, self.crop)

    def prepare(self, images: Sequence[np.ndarray]) -> np.ndarray:
        raw = np.stack(images)
        if raw.shape[1:] != (self.height, self.width):
            raise ValueError(f"expected {(self.height, self.width)} images, got {raw.shape[1:]}")
        return raw


def preprocess_device_shared(
    raw: torch.Tensor, w_h: torch.Tensor, w_w: torch.Tensor, channels: int = 3
) -> torch.Tensor:
    """(B, H, W) u8 with one shared (crop, H) / (crop, W) matrix pair ->
    (B, crop, crop, C) float32: two fp32 products (TF32 off on the card,
    as the JAX side's ``Precision.HIGHEST``), uint8 rounding, /255."""
    x = raw.to(torch.float32)
    out = torch.matmul(w_h, x)
    out = torch.matmul(out, w_w.transpose(0, 1))
    return _normalize_and_expand(apply_uint8_rounding(out), channels)


def expand_channels(x: torch.Tensor) -> torch.Tensor:
    """(..., 1) -> (..., 3) (``ExpandChannels``, DataRetrieval.py:27-40)."""
    if x.shape[-1] != 1:
        raise ValueError(f"Expected trailing channel dim 1, found {tuple(x.shape)}")
    return x.expand(*x.shape[:-1], 3)
