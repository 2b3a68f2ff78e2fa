"""Port vlp/engine.py and models/image_engine.py against the JAX package:
the gaussian smoothing (also against scipy), the map's return to the
image's geometry, and the image and image-text engines on a PNG through
the same BioViL and CXR-BERT weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from scipy import ndimage

from incremental_multimodal_medical_learning_ii_tpu.models import cxr_bert as jbert
from incremental_multimodal_medical_learning_ii_tpu.text.engine import (
    TextInferenceEngine as JaxTextEngine,
)
from incremental_multimodal_medical_learning_ii_tpu.text.tokenizer import (
    PromptTokenizer as JaxTokenizer,
)
from incremental_multimodal_medical_learning_ii_tpu.vlp import engine as jvlp
from incremental_multimodal_medical_learning_ii_torch.convert import params_from_jax
from incremental_multimodal_medical_learning_ii_torch.models.image_engine import (
    ImageInferenceEngine,
)
from incremental_multimodal_medical_learning_ii_torch.text.engine import TextInferenceEngine
from incremental_multimodal_medical_learning_ii_torch.text.tokenizer import (
    PromptTokenizer,
    write_test_vocab,
)
from incremental_multimodal_medical_learning_ii_torch.vlp import engine as tvlp

from torch_port_helpers import (  # noqa: F401
    assert_parity,
    biovil_numpy_params_from_port,
    one_torch_thread,
    to_numpy_tree,
)

SMOOTH_ATOL = 1e-6  # two separable 13-tap fp32 passes, summed in another order
# a two-tap blend per axis of O(1) values, its fp32 weights computed another
# way (jax.image.resize normalises a triangle kernel; torch clamps indices)
INTERP_ATOL = 1e-5
MAP_ATOL = 2e-4  # the ResNet bar: the map is patch embeddings . text embedding
SCORE_ATOL = 1e-4
GEOMETRY = dict(resize_size=72, crop_size=64)  # a 2 x 2 patch grid, kept small for the CPU
QUERY = "There is no pleural effusion"


@pytest.mark.parametrize("shape", [(15, 15), (2, 2), (1, 1), (4, 6)])
def test_gaussian_smooth_matches_jax_and_scipy(rng, shape):
    grid = rng.normal(size=shape).astype(np.float32)
    ours = tvlp.gaussian_smooth_2d(torch.from_numpy(grid), sigma=1.5).numpy()
    ref = np.asarray(jvlp.gaussian_smooth_2d(jnp.asarray(grid), sigma=1.5))
    scipy = ndimage.gaussian_filter(grid.astype(np.float64), sigma=(1.5, 1.5), order=0)
    assert ours.shape == shape
    assert_parity(f"gaussian smooth {shape}", ours, ref, SMOOTH_ATOL)
    assert_parity(f"gaussian smooth {shape} vs scipy", ours, scipy, SMOOTH_ATOL)
    np.testing.assert_array_equal(tvlp._gaussian_kernel_1d(1.5), jvlp._gaussian_kernel_1d(1.5))


@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
@pytest.mark.parametrize("width,height,resize,crop", [
    (78, 64, 64, 48),  # positive margins (the engine's geometry)
    (390, 320, 512, 480),  # CheXpert-small's common geometry at the defaults
    (40, 50, None, 64),  # crop larger than both sides: negative margins crop
    (60, 31, 64, 64),  # a target smaller than the grid on one side
    (9, 7, None, None),  # no crop: straight to the image size, below the grid
])
def test_convert_similarity_to_image_size_matches_jax(rng, mode, width, height, resize, crop):
    grid = rng.normal(size=(15, 15)).astype(np.float32)
    ours = tvlp.convert_similarity_to_image_size(grid, width, height, resize, crop, mode)
    ref = jvlp.convert_similarity_to_image_size(grid, width, height, resize, crop, mode)
    assert ours.shape == ref.shape == (height, width)
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(ref))
    ok = ~np.isnan(ref)
    assert_parity(f"similarity to image size {mode} {width}x{height} {resize}/{crop}",
                  ours[ok], ref[ok], INTERP_ATOL)
    with pytest.raises(ValueError, match="unsupported"):
        tvlp._interpolate(grid, (4, 4), "bicubic")


@pytest.fixture(scope="module")
def png(tmp_path_factory):
    """A 78 x 64 8-bit grayscale PNG (non-square: the map has NaN margins)."""
    path = tmp_path_factory.mktemp("vlp") / "cxr.png"
    pixels = np.random.default_rng(4).integers(0, 256, size=(64, 78), dtype=np.uint8)
    Image.fromarray(pixels, mode="L").save(path)
    return path


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """Both packages' image-text engines over the same weights."""
    image_tree = biovil_numpy_params_from_port(seed=0, bn_seed=3)
    vocab = write_test_vocab(tmp_path_factory.mktemp("vocab") / "vocab.txt")
    n_vocab = len(vocab.read_text().splitlines())
    jdims = jbert.tiny_bert_dims(vocab_size=n_vocab, max_position_embeddings=48,
                                 projection_size=128)
    text_tree = to_numpy_tree(jbert.init_cxr_bert(jax.random.PRNGKey(11), jdims))
    jax_image = jax.tree_util.tree_map(jnp.asarray, image_tree)
    jeng = jvlp.ImageTextInferenceEngine(jax_image, JaxTextEngine(text_tree, jdims,
                                                                  JaxTokenizer(vocab)),
                                         **GEOMETRY)
    teng = tvlp.ImageTextInferenceEngine(
        params_from_jax(image_tree),
        TextInferenceEngine(params_from_jax(text_tree, jdims), PromptTokenizer(vocab),
                            device="cpu"),
        device="cpu", **GEOMETRY)
    return jeng, teng, image_tree


def test_image_engine_matches_jax(engines, png):
    jeng, teng, image_tree = engines
    ours_emb = teng.image_engine.get_projected_global_embedding(png)
    ref_emb = jeng.image_engine.get_projected_global_embedding(png)
    assert ours_emb.shape == (128,) and abs(np.linalg.norm(ours_emb) - 1) < 1e-6
    assert_parity("image engine global embedding", ours_emb, ref_emb, MAP_ATOL)
    (ours, size), (ref, ref_size) = (teng.image_engine.get_projected_patch_embeddings(png),
                                     jeng.image_engine.get_projected_patch_embeddings(png))
    assert size == ref_size == (78, 64) and ours.shape == ref.shape == (2, 2, 128)
    assert_parity("image engine patch embeddings", ours, np.asarray(ref), MAP_ATOL)
    # the dtype knob: bf16 convolutions against fp32
    bf16 = ImageInferenceEngine(params_from_jax(image_tree), dtype=torch.bfloat16, device="cpu",
                                **GEOMETRY)
    low = bf16.get_projected_patch_embeddings(png)[0].reshape(-1, 128)
    cos = float(np.min(np.sum(low * ours.reshape(-1, 128), axis=-1)))
    print(f"PARITY image engine bf16 vs fp32 patches: min cos {cos:.6f} (> 0.999)")
    assert cos > 0.999


@pytest.mark.parametrize("interpolation", ["nearest", "bilinear"])
def test_image_text_engine_matches_jax(engines, png, interpolation):
    jeng, teng, _ = engines
    ours_score, ours_map = teng.get_score_and_map_from_raw_data(png, QUERY, interpolation)
    ref_score, ref_map = jeng.get_score_and_map_from_raw_data(png, QUERY, interpolation)
    assert ours_map.shape == ref_map.shape == (64, 78)
    np.testing.assert_array_equal(np.isnan(ours_map), np.isnan(ref_map))
    assert np.isnan(ours_map).any() and not np.isnan(ours_map).all()
    ok = ~np.isnan(ref_map)
    assert_parity(f"vlp map {interpolation}", ours_map[ok], ref_map[ok], MAP_ATOL)
    assert_parity("vlp score", ours_score, ref_score, SCORE_ATOL)
    # the separate raw-data methods give what the combined call gives
    one_map = teng.get_similarity_map_from_raw_data(png, QUERY, interpolation)
    np.testing.assert_allclose(one_map, ours_map, atol=1e-6, rtol=0)
    assert abs(teng.get_similarity_score_from_raw_data(png, QUERY) - ours_score) < 1e-6
    several = [QUERY, "Mild cardiomegaly."]
    assert_parity("vlp multi-prompt score", teng.get_similarity_score_from_raw_data(png, several),
                  jeng.get_similarity_score_from_raw_data(png, several), SCORE_ATOL)
    with pytest.raises(TypeError):
        teng.get_similarity_map_from_raw_data(png, several)


def test_grounding_figure_raises(png):
    """The three-panel figure raises nothing now that it is ported: its
    isolines at the four levels trace what matplotlib's contour generator
    (contourpy, the JAX figure's) traces on the same masked map (total
    length, 1e-9 relative), NaN cells draw none, and a flat or empty map
    draws no isoline (the JAX figure's ``except ValueError``)."""
    import contourpy

    sim = ndimage.gaussian_filter(np.random.default_rng(1).normal(size=(64, 78)), 3) * 8
    sim[:5] = np.nan
    sim[:, -7:] = np.nan
    fig = tvlp.plot_phrase_grounding_similarity_map(png, sim)
    assert fig.size == (1500, 600) and fig.image.mode == "RGB"
    assert fig.data["levels"] == tuple(np.linspace(0.25, 1, 4))
    gen = contourpy.contour_generator(z=np.ma.masked_invalid(sim), line_type="Separate")
    for level, segs in fig.data["isolines"].items():
        ref = sum(np.linalg.norm(np.diff(line, axis=0), axis=1).sum() for line in gen.lines(level))
        ours = np.linalg.norm(segs[:, 2:] - segs[:, :2], axis=1).sum()
        assert ref > 0 and abs(ours - ref) <= 1e-9 * ref, (level, ours, ref)
        assert np.all(segs[:, 1] >= 5) and np.all(segs[:, 0] <= 78 - 7)  # none in the NaN cells
    for flat in (np.full((64, 78), 0.5), np.full((64, 78), np.nan)):
        fig = tvlp.plot_phrase_grounding_similarity_map(png, flat)
        assert all(len(v) == 0 for v in fig.data["isolines"].values())
