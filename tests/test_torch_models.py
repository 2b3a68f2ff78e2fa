"""Port models/resnet.py, models/biovil_image.py and models/adapters.py
against the JAX package, with JAX parameters carried across."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incremental_multimodal_medical_learning_ii_tpu.models import adapters as jad
from incremental_multimodal_medical_learning_ii_tpu.models import biovil_image as jbv
from incremental_multimodal_medical_learning_ii_torch.convert import params_from_jax
from incremental_multimodal_medical_learning_ii_torch.models import adapters as tad
from incremental_multimodal_medical_learning_ii_torch.models import biovil_image as tbv

from torch_port_helpers import assert_parity, biovil_numpy_params, to_numpy_tree

# ResNet/projector: the JAX package's own torch-parity tolerance (PARITY.md)
RESNET_ATOL = 2e-4
# adapters: one or two fp32 products of width <= 256
ADAPTER_ATOL = 1e-6


@pytest.fixture(scope="module")
def carried():
    tree = biovil_numpy_params(seed=0, bn_seed=3)
    return tree, params_from_jax(tree)


def test_biovil_forward_fp32_matches_jax(carried):
    tree, model = carried
    x = np.random.default_rng(0).random((2, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        ours = tbv.biovil_image_forward(model, torch.from_numpy(x))
    ref = jbv.biovil_image_forward(tree, jnp.asarray(x))
    assert ours.projected_global_embedding.shape == (2, 128)
    assert ours.projected_patch_embeddings.shape == (2, 2, 2, 128)
    assert_parity("biovil global embedding", ours.projected_global_embedding.numpy(),
                  np.asarray(ref.projected_global_embedding), RESNET_ATOL)
    assert_parity("biovil patch embeddings", ours.projected_patch_embeddings.numpy(),
                  np.asarray(ref.projected_patch_embeddings), RESNET_ATOL)
    scale = max(1.0, float(np.abs(np.asarray(ref.img_embedding)).max()))
    assert_parity("biovil pooled trunk features / max", ours.img_embedding.numpy() / scale,
                  np.asarray(ref.img_embedding) / scale, RESNET_ATOL)


def test_fold_grayscale_conv1_keeps_embedding(carried):
    tree, model = carried
    gray = np.random.default_rng(1).random((2, 64, 64, 1)).astype(np.float32)
    folded = tbv.fold_grayscale_conv1(model)
    assert folded.encoder.conv1.weight.shape == (64, 1, 7, 7)
    assert model.encoder.conv1.weight.shape == (64, 3, 7, 7)  # the original is untouched
    assert tbv.fold_grayscale_conv1(folded) is folded
    with torch.no_grad():
        three = tbv.biovil_image_forward(model, torch.from_numpy(np.repeat(gray, 3, -1)))
        one = tbv.biovil_image_forward(folded, torch.from_numpy(gray))
    np.testing.assert_allclose(one.projected_global_embedding.numpy(),
                               three.projected_global_embedding.numpy(), atol=RESNET_ATOL, rtol=0)
    # the same fold as the JAX package's
    jf = jbv.fold_grayscale_conv1(tree)["encoder"]["conv1"]["kernel"]
    np.testing.assert_allclose(folded.encoder.conv1.weight.permute(2, 3, 1, 0).numpy(),
                               np.asarray(jf), rtol=0, atol=1e-6)


def test_random_init_shapes_and_scale():
    model = tbv.init_biovil_image_model(torch.Generator().manual_seed(0))
    w = model.encoder.layer1[0].conv2.weight
    assert w.shape == (64, 64, 3, 3)
    assert abs(float(w.std()) - np.sqrt(2.0 / (9 * 64))) < 0.01
    again = tbv.init_biovil_image_model(torch.Generator().manual_seed(0))
    assert torch.equal(again.encoder.layer4[2].conv3.weight, model.encoder.layer4[2].conv3.weight)
    # parameters: every conv kernel plus the projector's output bias (BN
    # statistics are buffers), as many as the JAX tree holds
    n_params = sum(p.numel() for p in model.parameters())
    jtree = jbv.init_biovil_image_model(jax.random.PRNGKey(0))
    n_kernels = sum(np.size(a) for a in jax.tree_util.tree_leaves(jtree) if np.ndim(a) == 4)
    assert n_params == n_kernels + np.size(jtree["projector"]["conv2"]["bias"])


@pytest.mark.parametrize(
    "kind,shared,use_image,use_text",
    [("mlp", False, True, True), ("mlp", True, True, True), ("dense", False, True, True),
     ("dense", True, True, True), ("mlp", False, True, False), ("dense", False, False, True),
     ("no-head", False, True, True)],
)
def test_adapters_match_jax(rng, kind, shared, use_image, use_text):
    jpair = jad.AdapterPair(jad.AdapterKind(kind), shared, use_image, use_text)
    jparams = to_numpy_tree(jpair.init(jax.random.PRNGKey(3)))
    tpair = tad.AdapterPair(kind, shared, use_image, use_text)
    tparams = params_from_jax(jparams)
    x = rng.normal(size=(7, 128)).astype(np.float32)
    for jfn, tfn in ((jpair.apply_image, tpair.apply_image), (jpair.apply_text, tpair.apply_text)):
        ref = np.asarray(jfn(jparams, jnp.asarray(x)))
        with torch.no_grad():
            ours = tfn(tparams, torch.from_numpy(x)).numpy()
        assert_parity(f"adapters {kind} shared={shared}", ours, ref, ADAPTER_ATOL)
    # the port's own init has the same structure and torch nn.Linear bounds
    own = tpair.init(torch.Generator().manual_seed(0))
    assert set(own) == set(jparams)
    for name, module in own.items():
        for layer in (m for m in module.modules() if isinstance(m, torch.nn.Linear)):
            bound = 1.0 / np.sqrt(layer.in_features)
            assert float(layer.weight.detach().abs().max()) <= bound
            assert float(layer.bias.detach().abs().max()) <= bound
