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


F64 = torch.float64  # the emulation's sums, and the plain version's it is held to


def _unswizzle(flat, rows):
    """A 128-byte-swizzled run of (rows, 64) bf16 back to row-major: the
    8-channel group c of row r sits at group c ^ (r % 8)."""
    t = flat.reshape(rows, 8, 8)
    idx = torch.arange(8)[None, :] ^ (torch.arange(rows) % 8)[:, None]
    return t[torch.arange(rows)[:, None], idx].reshape(rows, 64).to(F64)


def _emulate_block(t, w):
    """One launch of the CUDA kernel, tile by tile, in torch: 8 x 8 output
    tiles, each from its 10 x 10 input halo (zeros outside the image, as
    TMA fills them); ``a`` zeroed outside the image; bf16 where the kernel
    rounds.  The sums are float64 (the tensor cores' fp32 order cannot be
    reproduced here), held to the plain version with float64 sums, so what
    can differ is the tiling, the halo, the mask and the layout.  The
    weights come from the shared-memory image that ``_kernel_weights``
    lays out (pins that layout on the CPU)."""
    b, h, wd, cin = t.shape
    img, tile = w.image, 64 * 64
    n1 = cin // 64
    w1 = torch.cat([_unswizzle(img[k * tile:(k + 1) * tile], 64) for k in range(n1)], 1)
    w2 = [_unswizzle(img[(n1 + k) * tile:(n1 + k + 1) * tile], 64) for k in range(9)]
    o3 = (n1 + 9) * tile
    w3 = _unswizzle(img[o3:o3 + 4 * tile], 256)
    assert img.numel() == o3 + (8 if w.downsample else 4) * tile
    ty, tx = -(-h // 8), -(-wd // 8)
    xp = torch.zeros(b, ty * 8 + 2, tx * 8 + 2, cin, dtype=F64)
    xp[:, 1:h + 1, 1:wd + 1] = t.to(F64)
    halo = xp.unfold(1, 10, 8).unfold(2, 10, 8).permute(0, 1, 2, 4, 5, 3)  # (b, ty, tx, 10, 10, c)
    a = torch.relu(halo @ w1.T + w.b1.to(F64))
    iy = torch.arange(ty)[:, None] * 8 - 1 + torch.arange(10)[None, :]
    ix = torch.arange(tx)[:, None] * 8 - 1 + torch.arange(10)[None, :]
    inside = ((iy >= 0) & (iy < h))[:, None, :, None] & ((ix >= 0) & (ix < wd))[None, :, None, :]
    a = torch.where(inside[..., None], a, 0.0).to(torch.bfloat16).to(F64)
    acc = sum(torch.cat([a[..., dy:dy + 8, dx:dx + 8, :] for dy in range(3)], -1)
              @ torch.cat([w2[dy * 3 + dx] for dy in range(3)], 1).T for dx in range(3))
    hid = torch.relu(acc + w.b2.to(F64)).to(torch.bfloat16).to(F64)
    centre = halo[..., 1:9, 1:9, :]
    out = hid @ w3.T + w.b3.to(F64)
    if w.downsample:
        out = out + centre @ _unswizzle(img[o3 + 4 * tile:], 256).T
    else:
        out = out + centre
    out = torch.relu(out).to(torch.bfloat16)  # (b, ty, tx, 8, 8, 256)
    return out.permute(0, 1, 3, 2, 4, 5).reshape(b, ty * 8, tx * 8, -1)[:, :h, :wd]


def _emulate_kernel(x, folded):
    t = x.to(torch.bfloat16)
    for w in tfb._kernel_weights(folded, torch.device("cpu")):
        t = _emulate_block(t, w)
    return t


def _assert_emulation_matches_reference(x, folded):
    emu = _emulate_kernel(torch.from_numpy(x), folded).float().numpy()
    ref = tfb.fused_bottleneck_layer_reference(torch.from_numpy(x), folded, F64).float().numpy()
    assert emu.shape == ref.shape
    ulps = bf16_ulps(emu, ref)
    assert (emu == ref).mean() > 0.99 and (ulps > 1).mean() < 1e-3, ulps.max()


def test_kernel_weight_layout(case):
    _, x, folded_t, _ = case
    _assert_emulation_matches_reference(x, folded_t)


@pytest.mark.parametrize("shape", [(1, 40, 24, 64), (1, 120, 120, 64), (1, 37, 21, 64), (1, 5, 7, 64)])
def test_kernel_tiles_at_ragged_geometries(case, shape):
    """The serving crops' and other geometries: ragged edge tiles (37 x 21
    leaves parts of 8 x 8 tiles outside the image; 5 x 7 is smaller than
    one) and the halo mask on ``a`` at every image border (the relu(b1)
    that the randomised BN puts on zero input would leak into conv2
    without it)."""
    _, _, folded_t, _ = case
    x = (np.random.default_rng(2).normal(size=shape) * 0.5).astype(np.float32)
    _assert_emulation_matches_reference(x, folded_t)


def test_kernel_layout_refuses_other_widths(case):
    _, _, folded_t, _ = case
    with pytest.raises(ValueError, match="unsupported widths"):
        tfb._check_widths(256, folded_t)  # block 0 takes 64 channels
    narrow = {k: [t[..., :32] if k in ("w1", "b1") else t for t in v] for k, v in folded_t.items()}
    with pytest.raises(ValueError, match="width=32"):
        tfb._check_widths(64, narrow)


@pytest.mark.parametrize("operand", ["x", "w1"])
def test_fused_bottleneck_refuses_gradients_like_jax(case, operand):
    """No backward: where ``jax.grad`` through the Pallas layer kernel
    (interpret mode) fails, the wrapper raises on every device instead of
    returning a result cut from the autograd graph; under
    ``torch.no_grad()`` it computes as the plain version does."""
    _, x, folded_t, folded_j = case
    small = x[:1, :16, :16]
    if operand == "x":
        fn = lambda a: jpb.fused_bottleneck_layer(a, folded_j, rows_per_tile=16, interpret=True)
        arg = jnp.asarray(small)
    else:
        fn = lambda w: jpb.fused_bottleneck_layer(
            jnp.asarray(small), dict(folded_j, w1=[w.astype(jnp.bfloat16)] + folded_j["w1"][1:]),
            rows_per_tile=16, interpret=True)
        arg = jnp.asarray(folded_j["w1"][0], jnp.float32)
    with pytest.raises(AssertionError):
        jax.grad(lambda a: fn(a).astype(jnp.float32).sum())(arg)
    xt = torch.from_numpy(small).to(torch.bfloat16)
    folded = tfb.Folded({k: list(v) for k, v in folded_t.items()})
    if operand == "x":
        xt.requires_grad_(True)
    else:
        folded["w1"][0] = folded["w1"][0].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        tfb.fused_bottleneck_layer(xt, folded)
    with torch.no_grad():
        got = tfb.fused_bottleneck_layer(xt, folded)
        ref = tfb.fused_bottleneck_layer_reference(xt, folded)
    assert not got.requires_grad
    np.testing.assert_array_equal(got.float().numpy(), ref.float().numpy())


def _biovil_with_random_bn():
    from incremental_multimodal_medical_learning_ii_torch.models.biovil_image import (
        init_biovil_image_model,
    )

    model = init_biovil_image_model()
    rng = np.random.default_rng(11)
    with torch.no_grad():
        for block in model.encoder.layer1:
            for bn in (block.bn1, block.bn2, block.bn3):
                bn.bias.copy_(torch.from_numpy(rng.normal(size=bn.bias.shape).astype(np.float32) * 0.1))
    images = torch.from_numpy(rng.uniform(size=(1, 32, 32, 3)).astype(np.float32))
    return model, images


def test_layer1_is_folded_once_per_model(monkeypatch):
    """Two forwards fold layer1 once, and give what a fresh fold gives, bit
    for bit."""
    import copy

    from incremental_multimodal_medical_learning_ii_torch.models.biovil_image import (
        biovil_image_forward,
    )

    model, images = _biovil_with_random_bn()
    folds = []
    real = tfb.fold_bottleneck_layer
    monkeypatch.setattr(tfb, "fold_bottleneck_layer", lambda layer: folds.append(1) or real(layer))
    run = lambda m: biovil_image_forward(m, images, dtype=torch.bfloat16,  # noqa: E731
                                         fused_layer1=True).projected_patch_embeddings
    first, second = run(model), run(model)
    assert len(folds) == 1
    fresh = run(copy.deepcopy(model))  # new tensors: folded anew
    assert len(folds) == 2
    assert torch.equal(first, second) and torch.equal(first, fresh)


def test_inplace_bn_edit_refolds(monkeypatch):
    """An in-place edit of a layer1 BN buffer changes the output exactly as
    a fresh fold of the edited model does."""
    import copy

    from incremental_multimodal_medical_learning_ii_torch.models.biovil_image import (
        biovil_image_forward,
    )

    model, images = _biovil_with_random_bn()
    run = lambda m: biovil_image_forward(m, images, dtype=torch.bfloat16,  # noqa: E731
                                         fused_layer1=True).projected_patch_embeddings
    before = run(model)
    with torch.no_grad():
        model.encoder.layer1[1].bn2.var.mul_(2.0)
    after = run(model)
    assert not torch.equal(before, after)
    assert torch.equal(after, run(copy.deepcopy(model)))


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
