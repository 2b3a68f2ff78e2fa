"""Port ops/resize.py + ops/preprocess.py against the JAX package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incremental_multimodal_medical_learning_ii_tpu.ops import preprocess as jpre
from incremental_multimodal_medical_learning_ii_tpu.ops import resize as jres
from incremental_multimodal_medical_learning_ii_torch.ops import preprocess as tpre
from incremental_multimodal_medical_learning_ii_torch.ops import resize as tres

# mixed CheXpert-like geometries at a small scale, incl. a repeated shape,
# one smaller than the crop (CenterCrop pads) and one wider than tall
SHAPES = [(100, 80), (80, 100), (100, 80), (40, 50), (128, 96), (57, 91)]


def _images(rng, shapes):
    return [(rng.random(s) * 255).astype(np.uint8) for s in shapes]


@pytest.mark.parametrize("size,crop,pad_to", [(64, None, 128), (48, 40, 128)])
def test_prepare_deduped_matches_jax(rng, size, crop, pad_to):
    imgs = _images(rng, SHAPES)
    ours = tpre.DevicePreprocessPlan(size=size, crop=crop, pad_to=pad_to).prepare_deduped(imgs)
    ref = jpre.DevicePreprocessPlan(size=size, crop=crop, pad_to=pad_to).prepare_deduped(imgs)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("channels", [1, 3])
def test_preprocess_device_indexed_exact(rng, channels):
    imgs = _images(rng, SHAPES)
    raw, w_h, w_w, idx = tpre.DevicePreprocessPlan(size=64, pad_to=128).prepare_deduped(imgs)
    ours = tpre.preprocess_device_indexed(
        torch.from_numpy(raw), torch.from_numpy(w_h), torch.from_numpy(w_w),
        torch.from_numpy(idx), channels=channels,
    ).numpy()
    ref = np.asarray(jpre.preprocess_device_indexed(
        jnp.asarray(raw), jnp.asarray(w_h), jnp.asarray(w_w), jnp.asarray(idx),
        channels=channels,
    ))
    assert ours.shape == ref.shape == (len(imgs), 64, 64, channels)
    # exact after uint8 rounding: both sides hold the same 0..255 integers / 255
    np.testing.assert_array_equal(np.round(ours * 255), np.round(ref * 255))
    np.testing.assert_array_equal(ours, ref)


def test_resize_helpers_match_jax():
    for h, w in [(390, 320), (320, 451), (1024, 848), (7, 3)]:
        assert tres.resize_shape_for_smaller_edge(h, w, 512) == jres.resize_shape_for_smaller_edge(h, w, 512)
    np.testing.assert_array_equal(tres.resize_matrix(97, 64, 128), jres.resize_matrix(97, 64, 128))
    np.testing.assert_array_equal(tres.resize_matrix(40, 64), jres.resize_matrix(40, 64))
    x = np.array([-3.0, 0.5, 1.5, 2.5, 254.5, 300.0], np.float32)
    np.testing.assert_array_equal(
        tres.apply_uint8_rounding(torch.from_numpy(x)).numpy(),
        np.asarray(jres.apply_uint8_rounding(jnp.asarray(x))),
    )


def test_matrix_cache_is_byte_bounded(rng):
    plan = tpre.DevicePreprocessPlan(size=32, pad_to=64)
    plan._MATRIX_CACHE_MAX_BYTES = 3 * 2 * 32 * 64 * 4  # room for three pairs
    for s in [(40, 50), (41, 50), (42, 50), (43, 50)]:
        plan._matrices(*s)
    assert len(plan._matrix_cache) == 3 and (40, 50) not in plan._matrix_cache
    assert plan._matrix_cache_bytes == 3 * 2 * 32 * 64 * 4


def test_prepare_rejects_oversized():
    plan = tpre.DevicePreprocessPlan(size=32, pad_to=64)
    with pytest.raises(ValueError, match="exceeds pad_to"):
        plan.prepare_deduped([np.zeros((65, 10), np.uint8)])


def test_remap_to_uint8_matches_jax(rng):
    arr = rng.normal(size=(30, 20)) * 1000
    for pct in (None, (1.0, 99.0)):
        np.testing.assert_array_equal(tpre.remap_to_uint8(arr, pct), jpre.remap_to_uint8(arr, pct))
