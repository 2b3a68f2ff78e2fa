"""Port ops/fused_bottleneck.py against the JAX package's Pallas layer1
kernel (interpret mode) and its fp32 XLA block chain."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incremental_multimodal_medical_learning_ii_tpu.models.resnet import (
    _bottleneck_forward,
    _init_bottleneck,
)
from incremental_multimodal_medical_learning_ii_tpu.ops import pallas_bottleneck as jpb
from incremental_multimodal_medical_learning_ii_torch.convert import layer_from_jax
from incremental_multimodal_medical_learning_ii_torch.ops import fused_bottleneck as tfb

from torch_port_helpers import bf16_ulps, randomize_bn, to_numpy_tree


def _layer1_tree(seed=0, bn_seed=None):
    keys = jax.random.split(jax.random.PRNGKey(seed), 3)
    tree = to_numpy_tree(
        [_init_bottleneck(keys[bi], 64 if bi == 0 else 256, 64, stride=1) for bi in range(3)]
    )
    return randomize_bn(tree, np.random.default_rng(bn_seed)) if bn_seed is not None else tree


@pytest.fixture(scope="module")
def case():
    tree = _layer1_tree(bn_seed=5)
    x = (np.random.default_rng(27).normal(size=(2, 32, 32, 64)) * 0.5).astype(np.float32)
    folded_t = tfb.fold_bottleneck_layer(layer_from_jax(tree, 64, 64))
    folded_j = jpb.fold_bottleneck_layer(tree)
    return tree, x, folded_t, folded_j


def test_fold_matches_jax(case):
    _, _, folded_t, folded_j = case
    for key in ("w1", "b1", "w2", "b2", "w3", "b3", "wd"):
        assert len(folded_t[key]) == len(folded_j[key])
        for a, b in zip(folded_t[key], folded_j[key]):
            ours = a.float().numpy()
            ref = np.asarray(b, np.float32)
            assert ours.shape == ref.shape, key
            # same fp32 fold, same round-to-nearest-even bf16 cast
            np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-7, err_msg=key)


def _agreement(out, ref):
    rel = np.abs(out - ref) / np.maximum(np.abs(ref), 1.0)
    cos = np.sum(out * ref) / (np.linalg.norm(out) * np.linalg.norm(ref))
    return rel.max(), cos


def test_reference_matches_pallas_kernel_and_xla(case):
    tree, x, folded_t, folded_j = case
    ours = tfb.fused_bottleneck_layer_reference(torch.from_numpy(x), folded_t).float().numpy()
    pallas = np.asarray(
        jpb.fused_bottleneck_layer(jnp.asarray(x), folded_j, rows_per_tile=16, interpret=True),
        np.float32,
    )
    xla = jnp.asarray(x)
    for block in tree:
        xla = _bottleneck_forward(block, xla, stride=1)
    xla = np.asarray(xla)
    assert ours.shape == pallas.shape == xla.shape == (2, 32, 32, 256)
    # the JAX test's own bar (tests/test_pallas_bottleneck.py): bf16 compute
    for ref in (pallas, xla):
        rel, cos = _agreement(ours, ref)
        assert rel < 0.06, rel
        assert cos > 0.9999, cos
    # the same roundings as the TPU kernel: apart from accumulation order,
    # which can flip a bf16 rounding and carry it into the next block, the
    # two agree to the bit
    ulps = bf16_ulps(ours, pallas)
    print(f"max |reference - pallas| = {ulps.max():.1f} bf16 ulps; "
          f"{(ulps > 1).mean():.2e} of elements differ by > 1 ulp; "
          f"{(ours == pallas).mean():.4f} bit-equal")
    assert (ours == pallas).mean() > 0.95
    assert (ulps > 1).mean() < 1e-3


def test_wrapper_on_cpu_is_the_reference(case):
    _, x, folded_t, _ = case
    xb = torch.from_numpy(x).to(torch.bfloat16)
    np.testing.assert_array_equal(
        tfb.fused_bottleneck_layer(xb, folded_t).float().numpy(),
        tfb.fused_bottleneck_layer_reference(xb, folded_t).float().numpy(),
    )


def _emulate_kernel(x, folded):
    """The CUDA kernel's arithmetic in torch, from the weights in the
    layout the kernel receives (``_kernel_weights``): pins that layout
    (output-channel major, dy-major 3x3 taps) on the CPU."""
    blocks, wd = tfb._kernel_weights(folded, torch.device("cpu"))

    def gemm(a, w, taps, bias, extra=0.0, resid=None):
        n, h, wd_, c = a.shape
        if taps == 9:
            ap = torch.nn.functional.pad(a.float(), (0, 0, 1, 1, 1, 1))
            cols = torch.cat([ap[:, dy : dy + h, dx : dx + wd_] for dy in range(3) for dx in range(3)], -1)
        else:
            cols = a.float()
        v = cols @ w.float().T + extra + bias
        if resid is not None:
            v = v + resid.float()
        return torch.relu(v).to(torch.bfloat16)

    t = x.to(torch.bfloat16)
    for bi, (w1, b1, w2, b2, w3, b3) in enumerate(blocks):
        a = gemm(t, w1, 1, b1)
        h = gemm(a, w2, 9, b2)
        if bi == 0:
            t = gemm(h, w3, 1, b3, extra=t.float() @ wd.float().T)
        else:
            t = gemm(h, w3, 1, b3, resid=t)
    return t


def test_kernel_weight_layout(case):
    _, x, folded_t, _ = case
    emu = _emulate_kernel(torch.from_numpy(x), folded_t).float().numpy()
    ref = tfb.fused_bottleneck_layer_reference(torch.from_numpy(x), folded_t).float().numpy()
    ulps = bf16_ulps(emu, ref)
    assert (emu == ref).mean() > 0.99 and (ulps > 1).mean() < 1e-3, ulps.max()


@pytest.mark.parametrize("shape", [(1, 40, 24, 64), (1, 8, 8, 64)])
def test_reference_handles_other_geometries(case, shape):
    """Any H and W (the 480 crop gives H = W = 120; no row-tile divisor is
    needed on the port's side); the image border is zero padding."""
    tree, _, folded_t, _ = case
    x = (np.random.default_rng(1).normal(size=shape) * 0.5).astype(np.float32)
    ours = tfb.fused_bottleneck_layer_reference(torch.from_numpy(x), folded_t).float().numpy()
    xla = jnp.asarray(x)
    for block in tree:
        xla = _bottleneck_forward(block, xla, stride=1)
    rel, cos = _agreement(ours, np.asarray(xla))
    assert rel < 0.06 and cos > 0.9999, (rel, cos)


def test_fused_layer1_rejections():
    from incremental_multimodal_medical_learning_ii_torch.models.biovil_image import (
        biovil_image_forward,
        init_biovil_image_model,
    )

    model = init_biovil_image_model()
    img = torch.zeros(1, 64, 64, 3)
    with pytest.raises(ValueError, match="bfloat16"):
        biovil_image_forward(model, img, fused_layer1=True)
    with pytest.raises(ValueError, match="int8"):
        biovil_image_forward(model, img, dtype=torch.bfloat16, int8=True, fused_layer1=True)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        biovil_image_forward(model, img, int8=True)
