"""The rest of the port's image model surface against the JAX package at
64^2: dilated ResNet-50, ResNet-18, the space-to-depth stem (kernel,
forward, refusals), int8 sums of dilated convs, the ResNet-18 state-dict
converter, ``compare_params`` and ``encoder_output_dim``, with the JAX
weights carried across by ``params_from_jax``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incremental_multimodal_medical_learning_ii_tpu.models import biovil_image as jbv
from incremental_multimodal_medical_learning_ii_tpu.models import convert as jconv
from incremental_multimodal_medical_learning_ii_tpu.models import resnet as jr
from incremental_multimodal_medical_learning_ii_tpu.ops import quant as jq
from incremental_multimodal_medical_learning_ii_torch.convert import params_from_jax, params_to_jax
from incremental_multimodal_medical_learning_ii_torch.models import biovil_image as tbv
from incremental_multimodal_medical_learning_ii_torch.models import convert as tconv
from incremental_multimodal_medical_learning_ii_torch.models import resnet as tr
from incremental_multimodal_medical_learning_ii_torch.ops import quant as tq

from torch_port_helpers import (  # noqa: F401
    _torch_default_conv_scale,
    assert_parity,
    biovil_numpy_params_from_port,
    one_torch_thread,
    randomize_bn,
    to_numpy_tree,
)

RESNET_ATOL = 2e-4  # the ResNet bar (PARITY.md)


@pytest.fixture(scope="module")
def carried():
    tree = biovil_numpy_params_from_port(seed=0, bn_seed=3)
    return tree, params_from_jax(tree)


@pytest.fixture(scope="module")
def resnet18():
    """The JAX ResNet-18 init at torch's default conv scale with random BN
    statistics, and the port's ResNet-18 carried from it."""
    tree = to_numpy_tree(jr.init_resnet18(jax.random.PRNGKey(1)))
    tree = randomize_bn(_torch_default_conv_scale(tree), np.random.default_rng(2))
    return tree, params_from_jax(tree)


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(0).random((2, 64, 64, 3)).astype(np.float32)


@pytest.mark.parametrize("dilation", [(False, False, True), (False, True, True)])
def test_dilated_resnet50_matches_jax(carried, images, dilation):
    tree, model = carried
    ref = np.asarray(jr.resnet50_forward(tree["encoder"], jnp.asarray(images),
                                         replace_stride_with_dilation=dilation))
    with torch.no_grad():
        ours = tr.resnet50_forward(model.encoder, torch.from_numpy(images),
                                   replace_stride_with_dilation=dilation).numpy()
    side = 4 if dilation == (False, False, True) else 8  # x4 at /16 and /8 instead of /32
    assert ours.shape == ref.shape == (2, side, side, 2048)
    assert_parity(f"resnet50 dilation {dilation}", ours, ref, RESNET_ATOL)


def test_resnet18_matches_jax(resnet18, images):
    tree, model = resnet18
    assert isinstance(model, tr.ResNet18)
    ref = np.asarray(jr.resnet18_forward(tree, jnp.asarray(images)))
    with torch.no_grad():
        ours = tr.resnet18_forward(model, torch.from_numpy(images)).numpy()
    assert ours.shape == ref.shape == (2, 2, 2, 512)
    assert_parity("resnet18", ours, ref, RESNET_ATOL)
    # the port's own init: the same architecture and parameter count
    own = tr.init_resnet18(torch.Generator().manual_seed(0))
    n_kernels = sum(np.size(a) for a in jax.tree_util.tree_leaves(tree) if np.ndim(a) == 4)
    assert sum(p.numel() for p in own.parameters()) == n_kernels


@pytest.mark.parametrize("cin", [1, 3])
def test_space_to_depth_stem_kernel_is_bit_equal(rng, cin):
    k = rng.normal(size=(7, 7, cin, 64)).astype(np.float32)
    ref = np.asarray(jr.space_to_depth_stem_kernel(jnp.asarray(k)))
    ours = tr.space_to_depth_stem_kernel(torch.from_numpy(k).permute(3, 2, 0, 1))
    assert ours.shape == (64, 4 * cin, 4, 4)
    np.testing.assert_array_equal(ours.permute(2, 3, 1, 0).numpy(), ref)
    x = rng.random((2, 8, 6, cin)).astype(np.float32)
    np.testing.assert_array_equal(tr.space_to_depth_2x2(torch.from_numpy(x)).numpy(),
                                  np.asarray(jr.space_to_depth_2x2(jnp.asarray(x))))
    with pytest.raises(ValueError, match="7x7"):
        tr.space_to_depth_stem_kernel(torch.zeros(64, 1, 3, 3))


def test_space_to_depth_forward_matches_jax_and_the_standard_stem(carried):
    tree, model = carried
    gray = np.random.default_rng(1).random((2, 64, 64, 1)).astype(np.float32)
    jtree = jbv.space_to_depth_stem(jbv.fold_grayscale_conv1(tree))
    folded = tbv.fold_grayscale_conv1(model)
    s2d = tbv.space_to_depth_stem(folded)
    assert s2d.encoder.conv1.weight.shape == (64, 4, 4, 4)
    assert folded.encoder.conv1.weight.shape == (64, 1, 7, 7)  # the original is untouched
    assert tbv.space_to_depth_stem(s2d) is s2d
    assert tbv.fold_grayscale_conv1(s2d) is s2d  # folded before the transform
    ref = jbv.biovil_image_forward(jtree, jnp.asarray(gray))
    with torch.no_grad():
        ours = tbv.biovil_image_forward(s2d, torch.from_numpy(gray))
        std = tbv.biovil_image_forward(folded, torch.from_numpy(gray))
    for name in ("projected_global_embedding", "projected_patch_embeddings"):
        assert_parity(f"s2d stem {name}", getattr(ours, name).numpy(),
                      np.asarray(getattr(ref, name)), RESNET_ATOL)
        assert_parity(f"s2d stem vs standard stem {name}", getattr(ours, name).numpy(),
                      getattr(std, name).numpy(), RESNET_ATOL)
    # the JAX s2d tree carries across (a (4, 4, 4C, N) kernel), and back
    carried_s2d = params_from_jax(to_numpy_tree(jtree))
    assert torch.equal(carried_s2d.encoder.conv1.weight, s2d.encoder.conv1.weight)
    back = params_to_jax(carried_s2d)["encoder"]["conv1"]["kernel"]
    np.testing.assert_array_equal(back, np.asarray(jtree["encoder"]["conv1"]["kernel"]))


def test_space_to_depth_refusals(carried):
    tree, model = carried
    s2d3 = tbv.space_to_depth_stem(model)  # 3-channel s2d stem
    with pytest.raises(ValueError, match="BEFORE space_to_depth_stem"):
        tbv.fold_grayscale_conv1(s2d3)
    with pytest.raises(ValueError, match="BEFORE space_to_depth_stem"):
        jbv.fold_grayscale_conv1(jbv.space_to_depth_stem(tree))
    with pytest.raises(ValueError, match="space-to-depth stem"):
        tbv.quantize_biovil_int8(s2d3)
    with pytest.raises(ValueError, match="space-to-depth stem"):
        jbv.quantize_biovil_int8(jbv.space_to_depth_stem(tree))


@pytest.mark.parametrize("dilation,stride", [(2, 1), (4, 1), (2, 2)])
def test_int8_dilated_conv_sums_equal_jax(rng, dilation, stride):
    kq = rng.integers(-127, 128, size=(3, 3, 16, 8), dtype=np.int8)  # HWIO
    xq = rng.integers(-127, 128, size=(2, 13, 11, 16), dtype=np.int8)  # NHWC
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(xq), jnp.asarray(kq), (stride, stride), ((dilation, dilation),) * 2,
        rhs_dilation=(dilation, dilation), dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))
    xt = torch.from_numpy(xq).permute(0, 3, 1, 2)
    kt = torch.from_numpy(kq).permute(3, 2, 0, 1).contiguous()
    cpu = tq.conv_int8_sums(xt, kt, stride, dilation, dilation=dilation)
    mm = tq._int_mm_conv(xt, kt, stride, dilation, dilation)  # the card's im2col
    np.testing.assert_array_equal(cpu.permute(0, 2, 3, 1).numpy(), want)
    np.testing.assert_array_equal(mm.permute(0, 2, 3, 1).numpy(), want)


def test_int8_dilated_forward_matches_jax(carried):
    """The int8 trunk with layer 4 dilated: both packages' int8 forwards
    (per-call stride, padding and dilation through ``conv_apply_int8``)."""
    tree, model = carried
    x = np.random.default_rng(5).random((1, 64, 64, 3)).astype(np.float32)
    dil = (False, False, True)
    jq_tree = jq.quantize_resnet_int8(jax.tree_util.tree_map(jnp.asarray, tree["encoder"]))
    ref = np.asarray(jr.resnet50_forward(jq_tree, jnp.asarray(x), conv=jq.conv_apply_int8,
                                         replace_stride_with_dilation=dil))
    with torch.no_grad():
        ours = tr.resnet50_forward(tq.quantize_resnet_int8(model.encoder), torch.from_numpy(x),
                                   conv=tq.conv_apply_int8,
                                   replace_stride_with_dilation=dil).numpy()
    assert ours.shape == (1, 4, 4, 2048)
    # an activation rounding to the other int8 step (fp32 sums in another
    # order) moves an embedding by one quantum: held by cosine, as in
    # tests/test_torch_quant.py
    cos = float(np.dot(ours.ravel(), ref.ravel())
                / (np.linalg.norm(ours) * np.linalg.norm(ref)))
    print(f"PARITY int8 dilated resnet50: cos {cos:.7f} (> 0.9999)")
    assert cos > 0.9999


def _torchvision_state_dict(model: tr.ResNet18, prefix: str = "") -> dict:
    """The port's ResNet-18 under torchvision's state-dict keys."""
    bn_keys = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}
    sd = {}
    for key, value in model.state_dict().items():
        parts = key.replace("downsample_conv", "downsample.0").replace(
            "downsample_bn", "downsample.1").split(".")
        if parts[-1] in bn_keys:
            parts[-1] = bn_keys[parts[-1]]
        sd[prefix + ".".join(parts)] = value.numpy().copy()
    return sd


def test_convert_resnet18_compare_params_and_output_dim(resnet18):
    tree, model = resnet18
    sd = _torchvision_state_dict(model, prefix="encoder.")
    ours = tconv.convert_resnet18_state_dict(sd, prefix="encoder.")
    ref = jconv.convert_resnet18_state_dict(sd, prefix="encoder.")
    assert tconv.compare_params(ours, model, verbose=False) == []
    assert tconv.compare_params(params_from_jax(ref), ours, verbose=False) == []
    # one perturbed kernel: both packages name the one entry
    bumped = jax.tree_util.tree_map(np.copy, ref)
    bumped["layer3"][1]["conv2"]["kernel"][0, 0, 0, 0] += 1e-3
    j_bad = jconv.compare_params(ref, bumped, verbose=False)
    t_bad = tconv.compare_params(ours, params_from_jax(bumped), verbose=False)
    assert j_bad == ["['layer3'][1]['conv2']['kernel']"] and t_bad == ["layer3.1.conv2.weight"]
    assert tconv.compare_params(ours, params_from_jax(bumped), atol=2e-3, verbose=False) == []
    with pytest.raises(ValueError, match="different structures"):
        tconv.compare_params(ours, tr.ResNet50(), verbose=False)
    # a ResNet-18 checkpoint is not a BioViL image checkpoint
    with pytest.raises(ValueError, match="ResNet-50 trunk only"):
        tconv.convert_biovil_image_state_dict(sd)
    # the probed output widths, as in the JAX package
    assert tconv.encoder_output_dim(tr.resnet18_forward, model) == 512
    assert jconv.encoder_output_dim(jr.resnet18_forward, tree) == 512
    assert tconv.encoder_output_dim(tr.resnet50_forward, tr.ResNet50()) == 2048
    # params_to_jax inverts params_from_jax for a ResNet-18 tree
    back = params_to_jax(model)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)
