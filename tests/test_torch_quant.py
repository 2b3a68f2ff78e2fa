"""The port's int8 trunk (ops/quant.py, models/biovil_image.py::
quantize_biovil_int8) against the JAX package's: the quantized weights bit
for bit, single int8 convs and their int32 sums, the int8 BioViL
embedding, and the refusals."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incremental_multimodal_medical_learning_ii_tpu.models import biovil_image as jbio
from incremental_multimodal_medical_learning_ii_tpu.ops import quant as jq
from incremental_multimodal_medical_learning_ii_torch.convert import params_from_jax, params_to_jax
from incremental_multimodal_medical_learning_ii_torch.models import biovil_image as tbio
from incremental_multimodal_medical_learning_ii_torch.models.resnet import Conv2d
from incremental_multimodal_medical_learning_ii_torch.ops import quant as tq

from torch_port_helpers import biovil_numpy_params_from_port, one_torch_thread  # noqa: F401

EMB_ATOL = 2e-4  # the ResNet bar
FLIP_COS = 0.9999  # if an activation's rounding flips between the two packages


def _cos(a, b):
    return np.sum(a * b, axis=1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


@pytest.fixture(scope="module")
def trees():
    """Seeded weights (grayscale-folded, as extraction runs them) as a numpy
    tree, the port model carried from it, and both packages' quantized
    trunks."""
    tree = jbio.fold_grayscale_conv1(biovil_numpy_params_from_port(seed=0, bn_seed=3))
    tree = jax.tree_util.tree_map(np.asarray, tree)
    model = params_from_jax(tree)
    # eagerly, as JAX's extraction quantizes (under jit, XLA would turn
    # max|w| / 127 into a product with the reciprocal)
    jtree = jbio.quantize_biovil_int8(jax.tree_util.tree_map(jnp.asarray, tree))
    return tree, model, jtree, tbio.quantize_biovil_int8(model)


def test_quantized_trees_match_jax(trees):
    """Every conv's kernel_q bit-equal and w_scale equal; BN and the float
    projector untouched."""
    _, _, jtree, tmodel = trees
    ours = dict(jax.tree_util.tree_leaves_with_path(params_to_jax(tmodel)))
    ref = jax.tree_util.tree_leaves_with_path(jtree)
    assert {jax.tree_util.keystr(k) for k in ours} == {jax.tree_util.keystr(k) for k, _ in ref}
    n_q = 0
    for key, want in ref:
        got, want = ours[key], np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, key
        np.testing.assert_array_equal(got, want, err_msg=jax.tree_util.keystr(key))
        n_q += jax.tree_util.keystr(key).endswith("['kernel_q']")
    assert n_q == 53  # every conv of the trunk


def test_quantize_conv_matches_jax_on_edges(rng):
    """A zero output channel (scale clamped to 1e-12) and exact .5 ties."""
    k = rng.normal(size=(3, 3, 4, 8)).astype(np.float32)
    k[..., 2] = 0.0
    k[0, 0, 0, 3], k[0, 0, 1, 3] = 127.0, 0.5  # 0.5 / (127 / 127) rounds to even
    conv = Conv2d(4, 8, 3)
    conv.weight.data = torch.from_numpy(k).permute(3, 2, 0, 1).contiguous()
    ours = tq.quantize_conv_int8(conv)
    ref = jq.quantize_conv_int8({"kernel": jnp.asarray(k)})
    np.testing.assert_array_equal(ours.kernel_q.permute(2, 3, 1, 0).numpy(), np.asarray(ref["kernel_q"]))
    np.testing.assert_array_equal(ours.w_scale.numpy(), np.asarray(ref["w_scale"]))


CONVS = [  # (kh, cin, cout, stride, padding): the stem, a 3x3, 1x1s, as the trunk has them
    (7, 1, 64, 2, 3), (7, 3, 64, 2, 3), (3, 16, 16, 1, 1), (3, 16, 24, 2, 1),
    (1, 16, 32, 1, 0), (1, 16, 32, 2, 0),
]


@pytest.mark.parametrize("kh,cin,cout,stride,padding", CONVS)
def test_conv_apply_int8_matches_jax(rng, kh, cin, cout, stride, padding):
    """The dequantised output bit-equal to JAX's conv_apply_int8, and the
    int32 sums equal to lax.conv with int32 accumulation, on the CPU path
    and on the CUDA path's im2col + torch._int_mm (run here on the CPU)."""
    k = (rng.normal(size=(kh, kh, cin, cout)) * 0.1).astype(np.float32)
    x = rng.normal(size=(2, 19, 17, cin)).astype(np.float32)
    jp = jq.quantize_conv_int8({"kernel": jnp.asarray(k)})
    ref = np.asarray(jax.jit(jq.conv_apply_int8, static_argnums=(2, 3))(
        jp, jnp.asarray(x), stride, padding))  # jitted, as the JAX forward runs
    conv = Conv2d(cin, cout, kh, stride=stride, padding=padding)
    conv.weight.data = torch.from_numpy(k).permute(3, 2, 0, 1).contiguous()
    qconv = tq.quantize_conv_int8(conv)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    ours = tq.conv_apply_int8(qconv, xt).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(ours, ref)
    # the int32 sums themselves
    xq, _ = tq.quantize_activation(xt)
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(xq.permute(0, 2, 3, 1).numpy()), jp["kernel_q"], (stride, stride),
        ((padding, padding), (padding, padding)), dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))
    cpu = tq.conv_int8_sums(xq, qconv.kernel_q, stride, padding)
    mm = tq._int_mm_conv(xq, qconv.kernel_q, stride, padding)
    assert cpu.dtype == mm.dtype == torch.int32
    np.testing.assert_array_equal(cpu.permute(0, 2, 3, 1).numpy(), want)
    np.testing.assert_array_equal(mm.permute(0, 2, 3, 1).numpy(), want)


def test_int_mm_path_pads_small_row_counts(rng):
    """M <= 16 rows (torch._int_mm needs more) pads with zero rows."""
    kq = torch.from_numpy(rng.integers(-127, 128, size=(8, 3, 3, 3), dtype=np.int8))
    xq = torch.from_numpy(rng.integers(-127, 128, size=(1, 3, 4, 4), dtype=np.int8))
    np.testing.assert_array_equal(tq._int_mm_conv(xq, kq, 1, 1).numpy(),
                                  tq.conv_int8_sums(xq, kq, 1, 1).numpy())


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(8).random((2, 64, 64, 1)).astype(np.float32)


def _jax_int8_forward(p, x):
    """JAX's int8 embedding (jitted, as its extraction runs it), with the
    int8 activations of every conv, in call order."""
    from incremental_multimodal_medical_learning_ii_tpu.models.resnet import resnet50_forward

    acts = []

    def conv(pc, xx, stride, padding, dilation=1):
        x32 = xx.astype(jnp.float32)
        s_x = jnp.maximum(jnp.max(jnp.abs(x32)), 1e-12) / 127.0
        acts.append(jnp.clip(jnp.round(x32 / s_x), -127, 127).astype(jnp.int8))
        return jq.conv_apply_int8(pc, xx, stride, padding, dilation)

    patches = resnet50_forward(p["encoder"], x, conv=conv)
    proj = jbio._projector_forward(p["projector"], patches)
    return jnp.mean(proj.astype(jnp.float32), axis=(1, 2)), acts


def test_int8_embedding_matches_jax(trees, images):
    """2e-4 where no activation rounds to another int8 level in the two
    packages (their fp32 convs sum in different orders); otherwise the
    flips are counted and the embedding held to cosine > 0.9999."""
    _, model, jtree, tmodel = trees
    ref, ref_acts = jax.jit(_jax_int8_forward)(jtree, jnp.asarray(images))
    ref = np.asarray(ref)
    acts = []

    def conv(c, x):
        acts.append(tq.quantize_activation(x)[0].permute(0, 2, 3, 1).numpy())
        return tq.conv_apply_int8(c, x)

    with torch.no_grad():
        ours = tbio.biovil_image_forward(tmodel, torch.from_numpy(images),
                                         int8=True).projected_global_embedding.numpy()
        from incremental_multimodal_medical_learning_ii_torch.models.resnet import resnet50_forward

        resnet50_forward(tmodel.encoder, torch.from_numpy(images), conv=conv)
    assert len(acts) == len(ref_acts) == 53
    flips = [int((a != np.asarray(b)).sum()) for a, b in zip(acts, ref_acts)]
    first = next((i for i, f in enumerate(flips) if f), None)
    err = float(np.abs(ours - ref).max())
    cos = float(_cos(ours, ref).min())
    print(f"PARITY int8 embedding 64^2: max |port - jax| = {err:.3e}, min cos {cos:.8f}; "
          f"int8 activations that differ: {sum(flips)} of {sum(a.size for a in acts)}, "
          f"first at conv {first}")
    if first is None:
        assert err <= EMB_ATOL, err
    else:
        assert cos > FLIP_COS, (err, cos)
    # and the int8 trunk stays close to the float one (tests/test_quant.py:78,97)
    with torch.no_grad():
        flt = tbio.biovil_image_forward(model, torch.from_numpy(images)).projected_global_embedding
    assert _cos(ours, flt.numpy()).min() > 0.99


def test_int8_refusals(trees):
    _, model, _, tmodel = trees
    img = torch.zeros(1, 64, 64, 1)
    with pytest.raises(ValueError, match="int8"):
        tbio.biovil_image_forward(tmodel, img, dtype=torch.bfloat16, int8=True, fused_layer1=True)
    with pytest.raises(ValueError, match="quantized already"):
        tbio.quantize_biovil_int8(tmodel)
    with pytest.raises(ValueError, match="quantize_biovil_int8"):
        tbio.biovil_image_forward(model, img, int8=True)
    with pytest.raises(RuntimeError, match="conv_apply_int8"):
        tbio.biovil_image_forward(tmodel, img)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tq.conv_int8_sums(torch.zeros(1, 1, 4, 4, dtype=torch.int8, device="meta"),
                          torch.zeros(8, 1, 1, 1, dtype=torch.int8, device="meta"), 1, 0)
