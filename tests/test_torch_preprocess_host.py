"""The rest of the port's ops/preprocess.py against the JAX package's: the
host (PIL) path, the shared-size plan and its device path, and
expand_channels; bit for bit.

The device path's two fp32 products sum in another order than XLA's CPU
dot (neither is exact), so a pixel whose exact value lies on a uint8
rounding tie (k + 0.5 within fp32 error) may round to either side: such
pixels may differ by one level and are counted; every other pixel is
bit-equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incremental_multimodal_medical_learning_ii_tpu.ops import preprocess as jpre
from incremental_multimodal_medical_learning_ii_torch.ops import preprocess as tpre

# CheXpert-like geometries at a small scale: taller, wider, square, one
# whose resize is smaller than the crop (CenterCrop pads with black)
SHAPES = [(100, 80), (80, 100), (64, 64), (40, 50), (57, 91)]
# (size, crop): crop = size, a crop inside the resize, a crop larger than it
GEOMETRIES = [(64, None), (64, 48), (48, 64)]


TIE = 1e-3  # fp32 error of a resize sum of a few hundred 0..255 terms is ~1e-4


def assert_equal_off_ties(got, want, raw, w_h, w_w, what) -> int:
    """``got == want`` except on rounding ties of the exact (float64)
    resize, where they may differ by one uint8 level; returns the ties
    that differ."""
    exact = np.einsum("oh,bhw->bow", w_h.astype(np.float64), raw.astype(np.float64))
    exact = np.einsum("bow,pw->bop", exact, w_w.astype(np.float64))
    diff = got[..., 0] != want[..., 0]
    on_tie = np.abs(exact - np.floor(exact) - 0.5) < TIE
    assert not (diff & ~on_tie).any(), what
    assert np.all(np.abs(got[..., 0][diff] - want[..., 0][diff]) * 255 < 1 + 1e-4), what
    assert np.array_equal(got[..., 1:], np.broadcast_to(got[..., :1], got[..., 1:].shape))
    return int(diff.sum())


def _image(rng, shape):
    return (rng.random(shape) * 255).astype(np.uint8)


@pytest.mark.parametrize("size,crop", GEOMETRIES)
def test_preprocess_host_matches_jax(rng, size, crop):
    for shape in SHAPES:
        img = _image(rng, shape)
        ours = tpre.preprocess_host(img, size=size, crop=crop)
        ref = jpre.preprocess_host(img, size=size, crop=crop)
        assert ours.dtype == ref.dtype == np.float32
        assert ours.shape == ref.shape == (crop or size, crop or size, 3)
        np.testing.assert_array_equal(ours, ref, err_msg=str(shape))


def test_center_crop_bounds_match_jax():
    for h, w, crop in [(100, 80, 64), (89, 96, 96), (512, 624, 512), (30, 31, 40)]:
        assert tpre.center_crop_bounds(h, w, crop) == jpre.center_crop_bounds(h, w, crop)


@pytest.mark.parametrize("size,crop", GEOMETRIES)
@pytest.mark.parametrize("channels", [1, 3])
def test_shared_plan_and_device_path_match_jax(rng, size, crop, channels):
    ties = total = 0
    for shape in SHAPES:
        imgs = [_image(rng, shape) for _ in range(3)]
        ours = tpre.SharedSizePreprocessPlan(*shape, size=size, crop=crop)
        ref = jpre.SharedSizePreprocessPlan(*shape, size=size, crop=crop)
        np.testing.assert_array_equal(ours.w_h, ref.w_h)
        np.testing.assert_array_equal(ours.w_w, ref.w_w)
        raw = ours.prepare(imgs)
        np.testing.assert_array_equal(raw, ref.prepare(imgs))
        got = tpre.preprocess_device_shared(torch.from_numpy(raw), torch.from_numpy(ours.w_h),
                                            torch.from_numpy(ours.w_w), channels=channels).numpy()
        want = np.asarray(jpre.preprocess_device_shared(
            jnp.asarray(raw), jnp.asarray(ref.w_h), jnp.asarray(ref.w_w), channels=channels))
        assert got.shape == want.shape == (3, crop or size, crop or size, channels)
        ties += assert_equal_off_ties(got, want, raw, ours.w_h, ours.w_w, str(shape))
        total += got[..., 0].size
    print(f"PARITY shared preprocess size={size} crop={crop}: {ties} of {total} pixels "
          f"differ, all on fp32 rounding ties")


def test_shared_path_equals_the_indexed_path(rng):
    """One geometry through both device paths: the same pixels."""
    imgs = [_image(rng, (100, 80)) for _ in range(2)]
    sp = tpre.SharedSizePreprocessPlan(100, 80, size=64)
    shared = tpre.preprocess_device_shared(torch.from_numpy(sp.prepare(imgs)),
                                           torch.from_numpy(sp.w_h), torch.from_numpy(sp.w_w))
    raw, w_h, w_w, idx = tpre.DevicePreprocessPlan(size=64, pad_to=128).prepare_deduped(imgs)
    indexed = tpre.preprocess_device_indexed(*map(torch.from_numpy, (raw, w_h, w_w, idx)))
    torch.testing.assert_close(shared, indexed, rtol=0, atol=0)


def test_shared_plan_rejects_another_shape(rng):
    plan = tpre.SharedSizePreprocessPlan(100, 80, size=64)
    with pytest.raises(ValueError, match="expected"):
        plan.prepare([_image(rng, (80, 100))])


def test_expand_channels_matches_jax(rng):
    x = rng.random((2, 8, 8, 1)).astype(np.float32)
    ours = tpre.expand_channels(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jpre.expand_channels(jnp.asarray(x))))
    with pytest.raises(ValueError, match="trailing channel dim 1"):
        tpre.expand_channels(torch.zeros(2, 8, 8, 3))
