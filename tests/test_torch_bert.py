"""Port models/cxr_bert.py against the JAX package's: the dense path in
fp32 and bf16, the knobs (fuse_qkv, attention_core), the MLM head, the
flash path against the JAX flash path (Pallas in TPU interpret mode), and
params_from_jax on the BERT tree."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from incremental_multimodal_medical_learning_ii_tpu.models import cxr_bert as jbert
from incremental_multimodal_medical_learning_ii_torch.convert import params_from_jax
from incremental_multimodal_medical_learning_ii_torch.models import cxr_bert as tbert

from torch_port_helpers import assert_parity, to_numpy_tree

ATOL = 3e-5  # the JAX package's BERT torch-parity tolerance (PARITY.md:89)


def _inputs(rng, dims, batch, seq, short_rows=(1,)):
    ids = rng.integers(0, dims.vocab_size, size=(batch, seq)).astype(np.int32)
    mask = np.ones((batch, seq), np.int32)
    for r in short_rows:
        mask[r, seq - seq // 3:] = 0  # padded tail
    return ids, mask


def _models(dims_kw, seed=0):
    jdims = jbert.tiny_bert_dims(**dims_kw)
    # jitted: one XLA program is quicker on the CPU than eager op-by-op
    tree = to_numpy_tree(jax.jit(jbert.init_cxr_bert, static_argnums=1)(
        jax.random.PRNGKey(seed), jdims))
    return jdims, tree, params_from_jax(tree, jdims)


@pytest.fixture(scope="module")
def tiny():
    jdims, tree, model = _models({})
    ids, mask = _inputs(np.random.default_rng(5), jdims, batch=3, seq=12, short_rows=(1, 2))
    mask[2, 3:] = 0
    return jdims, tree, model, ids, mask


def _dense_core_jax(q, k, v, mask_bias):
    scores = jnp.einsum("bnqd,bnkd->bnqk", q, k, precision=jax.lax.Precision.HIGHEST)
    probs = jax.nn.softmax(scores / np.sqrt(q.shape[-1]) + mask_bias, axis=-1)
    return jnp.einsum("bnqk,bnkd->bnqd", probs, v, precision=jax.lax.Precision.HIGHEST)


def _dense_core_torch(q, k, v, mask_bias):
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    return torch.matmul(torch.softmax(scores + mask_bias, dim=-1), v)


@pytest.mark.parametrize("what", ["encode", "projected", "projected_normalized", "mlm",
                                  "fuse_qkv", "attention_core"])
def test_dense_fp32_matches_jax(tiny, what):
    jdims, tree, model, ids, mask = tiny
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jids, jmask, tids, tmask = jnp.asarray(ids), jnp.asarray(mask), torch.from_numpy(ids), \
        torch.from_numpy(mask)
    with torch.no_grad():
        if what in ("encode", "fuse_qkv", "attention_core"):
            kw_j = {"fuse_qkv": True} if what == "fuse_qkv" else {}
            kw_t = dict(kw_j)
            if what == "attention_core":
                kw_j, kw_t = {"attention_core": _dense_core_jax}, {"attention_core": _dense_core_torch}
            ref = jax.jit(lambda p, i, m: jbert.bert_encode(p, i, m, jdims, **kw_j))(
                jparams, jids, jmask)
            ours = tbert.bert_encode(model, tids, tmask, **kw_t)
        elif what.startswith("projected"):
            norm = what.endswith("normalized")
            ref = jax.jit(lambda p, i, m: jbert.get_projected_text_embeddings(
                p, i, m, jdims, normalize=norm))(jparams, jids, jmask)
            ours = tbert.get_projected_text_embeddings(model, tids, tmask, normalize=norm)
            if norm:
                np.testing.assert_allclose(np.linalg.norm(ours.numpy(), axis=-1), 1.0, atol=1e-6)
        else:
            ref = jax.jit(lambda p, i, m: jbert.mlm_logits(p, jbert.bert_encode(p, i, m, jdims)))(
                jparams, jids, jmask)
            ours = tbert.mlm_logits(model, tbert.bert_encode(model, tids, tmask))
    assert ours.dtype == torch.float32 and tuple(ours.shape) == ref.shape
    assert_parity(f"cxr_bert {what} fp32", ours.numpy(), np.asarray(ref), ATOL)


def test_embed_inputs_position_offset_and_token_types(tiny):
    jdims, tree, model, ids, _ = tiny
    tt = (np.arange(ids.shape[1])[None, :] >= 6).astype(np.int32).repeat(ids.shape[0], 0)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    ref = jbert.embed_inputs(jparams, jnp.asarray(ids), jnp.asarray(tt), position_offset=7)
    ours = tbert.embed_inputs(model, torch.from_numpy(ids), torch.from_numpy(tt), position_offset=7)
    assert_parity("cxr_bert embed_inputs offset 7", ours.numpy(), np.asarray(ref), 1e-6)
    bias = tbert.attention_mask_bias(torch.tensor([[1, 1, 0]]))
    np.testing.assert_array_equal(bias.numpy(), np.asarray(
        jbert.attention_mask_bias(jnp.asarray([[1, 1, 0]]))))


def test_flash_path_matches_jax_flash_interpret():
    """Hidden 128, 2 heads (hd 64), one layer, S = 128, one row padded: the
    port's flash branch (the kernel's plain version on the CPU) against the
    JAX flash branch with the Pallas kernel in interpret mode, on every
    position (the segment semantics are the same), and against the port's
    dense path on valid positions."""
    jdims, tree, model = _models(dict(hidden_size=128, num_heads=2, intermediate_size=256,
                                      num_layers=1, max_position_embeddings=128), seed=1)
    ids, mask = _inputs(np.random.default_rng(9), jdims, batch=2, seq=128)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax.jit(lambda p, i, m: jbert.bert_encode(
            p, i, m, jdims, use_flash_attention=True))(jparams, jnp.asarray(ids), jnp.asarray(mask)))
    with torch.no_grad():
        tids, tmask = torch.from_numpy(ids), torch.from_numpy(mask)
        ours = tbert.bert_encode(model, tids, tmask, use_flash_attention=True).numpy()
        dense = tbert.bert_encode(model, tids, tmask).numpy()
    assert_parity("cxr_bert flash (1 layer, S=128) vs jax flash interpret", ours, ref, ATOL)
    valid = mask == 1
    assert_parity("cxr_bert flash vs dense, valid positions", ours[valid], dense[valid], ATOL)


def _cos(a, b, axis=None):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.sum(a * b, axis=axis) / (np.linalg.norm(a, axis=axis) * np.linalg.norm(b, axis=axis))


def test_bf16_matches_jax_bf16(rng):
    """bf16 rounds at other points in the two frameworks: held to the bars
    of tests/test_bert_bf16.py (hidden cos > 0.999, projected cos > 0.995)."""
    jdims, tree, model = _models(dict(num_heads=4, hidden_size=64, intermediate_size=128), seed=3)
    ids, mask = _inputs(rng, jdims, batch=4, seq=16, short_rows=(0, 3))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jids, jmask = jnp.asarray(ids), jnp.asarray(mask)
    ref_h = jax.jit(lambda p, i, m: jbert.bert_encode(p, i, m, jdims, dtype=jnp.bfloat16))(
        jparams, jids, jmask)
    ref_p = jax.jit(lambda p, i, m: jbert.get_projected_text_embeddings(
        p, i, m, jdims, normalize=True, dtype=jnp.bfloat16))(jparams, jids, jmask)
    with torch.no_grad():
        tids, tmask = torch.from_numpy(ids), torch.from_numpy(mask)
        h = tbert.bert_encode(model, tids, tmask, dtype=torch.bfloat16)
        p = tbert.get_projected_text_embeddings(model, tids, tmask, normalize=True,
                                                dtype=torch.bfloat16)
    assert h.dtype == torch.bfloat16 and p.dtype == torch.float32
    valid = mask == 1
    cos_h = _cos(h.float().numpy()[valid], np.asarray(ref_h, np.float32)[valid])
    cos_p = _cos(p.numpy(), np.asarray(ref_p), axis=-1).min()
    print(f"PARITY cxr_bert bf16: hidden cos {cos_h:.6f} (> 0.999), projected min cos "
          f"{cos_p:.6f} (> 0.995)")
    assert cos_h > 0.999 and cos_p > 0.995


@pytest.mark.parametrize("projection", [True, False])
def test_params_from_jax_bert_tree(projection):
    jdims = jbert.tiny_bert_dims(num_layers=1)
    tree = to_numpy_tree(jax.jit(jbert.init_cxr_bert, static_argnums=1)(
        jax.random.PRNGKey(2), jdims))
    if not projection:
        del tree["cls_projection"]
    model = params_from_jax(tree, jdims)
    assert model.dims == tbert.tiny_bert_dims(num_layers=1)
    assert (model.cls_projection is not None) == projection
    layer, p = model.layers[0], tree["layers"][0]
    np.testing.assert_array_equal(layer.q.weight.numpy(), p["q"]["kernel"].T)
    np.testing.assert_array_equal(layer.ffn_out.bias.numpy(), p["ffn_out"]["bias"])
    np.testing.assert_array_equal(layer.attn_ln.weight.numpy(), p["attn_ln"]["scale"])
    np.testing.assert_array_equal(model.embeddings.position.weight.numpy(),
                                  tree["embeddings"]["position"])
    np.testing.assert_array_equal(model.mlm_head.decoder_bias.numpy(),
                                  tree["mlm_head"]["decoder_bias"])
    assert not any(t.requires_grad for t in model.parameters())
    with pytest.raises(ValueError, match="needs dims"):
        params_from_jax(tree)


def test_init_cxr_bert_is_seeded():
    dims = tbert.tiny_bert_dims()
    a = tbert.init_cxr_bert(torch.Generator().manual_seed(4), dims)
    b = tbert.init_cxr_bert(torch.Generator().manual_seed(4), dims)
    for (name, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(x, y), name
    w = a.layers[0].ffn_in.weight
    assert abs(float(w.std()) - 0.02) < 0.005 and float(a.layers[0].ffn_in.bias.abs().max()) == 0
