"""The text tower's tensor-, sequence- and pipeline-parallel encodes
(``parallel/{tp,sp,pp}.py``) and ``TextInferenceEngine(mesh=)`` on four
gloo ranks on the CPU, each partition on a 2 x 2 mesh, against the JAX
package's ``make_{tp,sp,pp}_text_encode`` on ``create_mesh_2d(2, 2)``,
``create_mesh_sp(2, 2)`` and ``create_mesh_pp(2, 2)`` (conftest.py's CPU
devices): outputs, bf16, TP at BERT-base width, gradients against
``jax.grad`` of the dense JAX path, the engine with padding, and the
shape and divisibility errors."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incremental_multimodal_medical_learning_ii_tpu.models.cxr_bert import (
    BertDims as JDims,
    get_projected_text_embeddings as j_projected,
    init_cxr_bert as j_init,
    tiny_bert_dims as j_tiny,
)
from incremental_multimodal_medical_learning_ii_tpu.parallel import pp as jpp
from incremental_multimodal_medical_learning_ii_tpu.parallel import sp as jsp
from incremental_multimodal_medical_learning_ii_tpu.parallel import tp as jtp
from incremental_multimodal_medical_learning_ii_tpu.text.engine import (
    TextInferenceEngine as JEngine,
)
from incremental_multimodal_medical_learning_ii_tpu.text.tokenizer import (
    PromptTokenizer as JTokenizer,
)
from incremental_multimodal_medical_learning_ii_torch.convert import params_from_jax, params_to_jax
from incremental_multimodal_medical_learning_ii_torch.models.cxr_bert import (
    BertDims,
    init_cxr_bert,
    tiny_bert_dims,
)
from incremental_multimodal_medical_learning_ii_torch.parallel import mesh as tmesh
from incremental_multimodal_medical_learning_ii_torch.parallel import pp, sp, tp
from incremental_multimodal_medical_learning_ii_torch.text.engine import TextInferenceEngine
from incremental_multimodal_medical_learning_ii_torch.text.tokenizer import (
    PromptTokenizer,
    write_test_vocab,
)

from torch_port_helpers import assert_parity, text_partitions_on_rank, to_numpy_tree

PART_ATOL = 2e-5  # test_tp.py:50, test_sp.py:101, test_pp.py:46
WIDE_ATOL = 5e-5  # BERT-base width, test_tp.py:103
GRAD_ATOL = 5e-5  # scaled by the largest gradient, test_sp.py:199
ENGINE_ATOL = 3e-5  # test_sp.py:276
BF16_COS = {"tp": 0.995, "sp": 0.999, "pp": 0.999}  # test_tp.py:61, test_sp.py:164, test_pp.py
PROMPTS = ["Findings suggesting Edema", "No evidence of Atelectasis", "Pleural Effusion seen"]
J_MESHES = {"tp": jtp.create_mesh_2d, "sp": jsp.create_mesh_sp, "pp": jpp.create_mesh_pp}


def _tokens(seed, dims, b, s, pads):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, dims.vocab_size, size=(b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    for row, start in pads:
        mask[row, start:] = 0
    return ids, mask


# partition -> (dims, JAX init key, (batch, seq), padded (row, from) of the
# mask): the shapes of the JAX tests
FORWARD = {
    "tp": (j_tiny(num_heads=8, intermediate_size=64, hidden_size=32), 0, (8, 12),
           [(r, 9) for r in range(8)]),
    "sp": (j_tiny(), 3, (4, 32), [(0, 10), (2, 29)]),
    "pp": (j_tiny(num_layers=4), 0, (8, 16), [(0, 8), (2, 13)]),
}
GRAD = {"tp": j_tiny(num_heads=4), "sp": j_tiny(), "pp": j_tiny(num_layers=2)}


# the dense JAX path, compiled once a shape (op by op it takes seconds a call)
_dense = jax.jit(j_projected, static_argnums=(3,), static_argnames=("normalize", "dtype"))


def _jax_encode(part, dims, params, ids, mask, dtype=None):
    mesh = J_MESHES[part](2, 2)
    if part == "tp":
        encode = jtp.make_tp_text_encode(dims, mesh, dtype=dtype)
        params = jtp.shard_bert_tp(params, mesh, dims)
    elif part == "sp":
        encode = jsp.make_sp_text_encode(dims, mesh, dtype=dtype)
    else:
        encode = jpp.make_pp_text_encode(dims, mesh, 2, dtype=dtype)
    return np.asarray(encode(params, jnp.asarray(ids), jnp.asarray(mask)))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The cases, the JAX references, and one spawn of four ranks."""
    cases, refs = {}, {}
    for part, (dims, key, (b, s), pads) in FORWARD.items():
        params = j_init(jax.random.PRNGKey(key), dims)
        tree = to_numpy_tree(params)
        ids, mask = _tokens(key, dims, b, s, pads)
        kw = dataclasses.asdict(dims)
        cases[part] = (part, kw, tree, ids, mask, "float32", False)
        refs[part] = _jax_encode(part, dims, params, ids, mask)
        cases[f"{part} bf16"] = (part, kw, tree, ids, mask, "bfloat16", False)
        # TP's bf16 bar is against the fp32 path (test_tp.py), the others'
        # against the dense bf16 path
        refs[f"{part} bf16"] = refs[part] if part == "tp" else np.asarray(_dense(
            params, jnp.asarray(ids), jnp.asarray(mask), dims, normalize=True, dtype=jnp.bfloat16))
    for part, dims in GRAD.items():
        params = j_init(jax.random.PRNGKey(21), dims)
        ids, mask = _tokens(21, dims, 4, 16, [(1, 11)])

        def loss(p, ids=ids, mask=mask, dims=dims):
            out = j_projected(p, jnp.asarray(ids), jnp.asarray(mask), dims, normalize=True)
            return jnp.sum(out * out[::-1])

        grads = params_from_jax(to_numpy_tree(jax.jit(jax.grad(loss))(params)), BertDims(
            **dataclasses.asdict(dims)))
        refs[f"grad {part}"] = {k: v.numpy() for k, v in grads.state_dict().items()}
        cases[f"grad {part}"] = (part, dataclasses.asdict(dims), to_numpy_tree(params), ids, mask,
                                 "float32", True)
    # BERT-base width, 2 layers, from the port's init; the reference is the
    # dense JAX path on the same weights
    wide_dims = BertDims(num_layers=2)
    ids, mask = _tokens(4, wide_dims, 4, 16, [(r, 13) for r in range(4)])
    wide_tree = params_to_jax(init_cxr_bert(torch.Generator().manual_seed(4), wide_dims))
    refs["wide"] = np.asarray(_dense(wide_tree, jnp.asarray(ids), jnp.asarray(mask),
                                     JDims(num_layers=2), normalize=True))
    wide = (dataclasses.asdict(wide_dims), 4, ids, mask)
    del wide_tree
    vocab = write_test_vocab(tmp_path_factory.mktemp("vocab") / "vocab.txt")
    vocab_size = JTokenizer(vocab).tokenizer.vocab_size
    trees = {}
    for part in ("tp", "sp", "pp"):
        dims = j_tiny(vocab_size=vocab_size, max_position_embeddings=64, num_heads=4,
                      num_layers=4 if part == "pp" else 2)
        params = j_init(jax.random.PRNGKey(13), dims)
        trees[part] = (dataclasses.asdict(dims), to_numpy_tree(params))
        refs[f"engine {part}"] = JEngine(params, dims, JTokenizer(vocab, max_allowed_input_length=64)
                                         ).get_embeddings_from_prompt(PROMPTS, normalize=True)
    ranks = tmesh.spawn_ranks(text_partitions_on_rank, (2, 2), "cpu", cases, wide,
                              (str(vocab), trees, PROMPTS))
    return ranks, refs


@pytest.mark.parametrize("part", ["tp", "sp", "pp"])
def test_partition_matches_jax(setup, part):
    """Every rank returns the whole batch in row order: the JAX partition's
    output (which is the dense path's within the same bar)."""
    ranks, refs = setup
    for rank, r in enumerate(ranks):
        assert_parity(f"{part} rank {rank}", r[part]["out"], refs[part], PART_ATOL)


@pytest.mark.parametrize("part", ["tp", "sp", "pp"])
def test_partition_composes_with_bf16(setup, part):
    ranks, refs = setup
    got, ref = ranks[0][f"{part} bf16"]["out"], refs[f"{part} bf16"]
    cos = np.sum(got * ref, -1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(ref, axis=-1))
    print(f"PARITY {part} bf16: min row cos = {cos.min():.7f} (bar {BF16_COS[part]})")
    assert cos.min() > BF16_COS[part], cos.min()


def test_tp_at_bert_base_width(setup):
    """768 wide, 12 heads of 64, two ranks on ``model``: 6 heads a rank."""
    ranks, refs = setup
    for r in ranks:
        assert r["wide"]["q_rows"] == (384, 768)
        assert_parity("tp at BERT-base width", r["wide"]["out"], refs["wide"], WIDE_ATOL)


@pytest.mark.parametrize("part", ["tp", "sp", "pp"])
def test_gradients_match_jax_grad(setup, part):
    """The whole gradient of every parameter (``full_gradients``) against
    ``jax.grad`` of the dense JAX path, scaled by its largest entry."""
    ranks, refs = setup
    ref = refs[f"grad {part}"]
    scale = max(float(np.abs(v).max()) for v in ref.values()) + 1e-12
    for r in ranks:
        got = r[f"grad {part}"]["grads"]
        assert sorted(got) == sorted(ref)
        err = max(float(np.abs(got[name] - ref[name]).max()) for name in ref) / scale
        print(f"PARITY {part} gradients: max |port - jax| / largest = {err:.3e}")
        for name in ref:
            np.testing.assert_allclose(got[name] / scale, ref[name] / scale, rtol=0,
                                       atol=GRAD_ATOL, err_msg=name)


@pytest.mark.parametrize("part", ["tp", "sp", "pp"])
def test_engine_partitions_with_padding(setup, part):
    """3 prompts on a mesh whose divisibility needs padding (data 2, and
    2 microbatches for pp; the sequence to a multiple of 2 for sp): the
    dummy rows are stripped."""
    ranks, refs = setup
    for r in ranks:
        got = r[f"engine {part}"]["out"]
        assert got.shape == refs[f"engine {part}"].shape
        assert_parity(f"engine {part}", got, refs[f"engine {part}"], ENGINE_ATOL)


def _fake(names, shape):
    """A 2-D mesh's shape without process groups (the checks read it only)."""
    return tmesh.Mesh(rank=0, size=int(np.prod(shape)), device=torch.device("cpu"),
                      backend="gloo", group=None, axes=tuple(zip(names, shape)))


def _same_error(jax_call, port_call):
    with pytest.raises(ValueError) as jerr:
        jax_call()
    with pytest.raises(ValueError) as terr:
        port_call()
    assert str(terr.value) == str(jerr.value)


def test_shape_and_divisibility_errors_match_jax():
    sp_mesh, pp_mesh = _fake(("data", "seq"), (2, 4)), _fake(("data", "pipe"), (2, 4))
    j_sp, j_pp = jsp.create_mesh_sp(2, 4), jpp.create_mesh_pp(2, 4)
    for kw in (dict(num_heads=6), dict(num_heads=8, intermediate_size=60)):
        _same_error(lambda: jtp.check_tp_divisibility(j_tiny(**kw), 8 if "intermediate_size" in kw
                                                      else 4),
                    lambda: tp.check_tp_divisibility(tiny_bert_dims(**kw), 8 if "intermediate_size"
                                                     in kw else 4))
    for b, s in ((4, 30), (3, 32), (4, 68)):
        _same_error(lambda: jsp.check_sp_shapes(j_tiny(), b, s, j_sp),
                    lambda: sp.check_sp_shapes(tiny_bert_dims(), b, s, sp_mesh))
    for layers, b, m in ((3, 8, 2), (4, 7, 1), (4, 8, 3)):
        _same_error(lambda: jpp.check_pp_shapes(j_tiny(num_layers=layers), b, m, j_pp),
                    lambda: pp.check_pp_shapes(tiny_bert_dims(num_layers=layers), b, m, pp_mesh))
    ids, mask = np.ones((2, 30), np.int32), np.ones((2, 30), np.int32)
    for got, ref in zip(sp.pad_tokens_for_sp(ids, mask, 8), jsp.pad_tokens_for_sp(ids, mask, 8)):
        np.testing.assert_array_equal(got, ref)
    assert (tp.MODEL_AXIS, sp.SEQ_AXIS, pp.PIPE_AXIS) == (jtp.MODEL_AXIS, jsp.SEQ_AXIS,
                                                          jpp.PIPE_AXIS)


def test_unknown_partition_raises_as_jax_does(tmp_path):
    vocab = write_test_vocab(tmp_path / "vocab.txt")
    dims = j_tiny()
    with pytest.raises(ValueError) as jerr:
        JEngine(j_init(jax.random.PRNGKey(0), dims), dims, JTokenizer(vocab), mesh=object(),
                partition="dp")
    with pytest.raises(ValueError) as terr:
        TextInferenceEngine(init_cxr_bert(dims=tiny_bert_dims()), PromptTokenizer(vocab),
                            mesh=_fake(("data", "model"), (1, 2)), partition="dp")
    assert str(terr.value) == str(jerr.value) == "unknown partition 'dp'"
