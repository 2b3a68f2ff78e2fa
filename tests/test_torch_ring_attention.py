"""``ops/ring_attention.py`` and the point-to-point and differentiable
collectives of ``parallel/mesh.py`` (``ppermute``, ``psum``, ``pvary``, the
2-D views) on gloo ranks on the CPU: the ring against dense attention and
against the JAX package's ring on a 4-device CPU mesh, fully masked chunks
included, with its gradients against dense attention's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incremental_multimodal_medical_learning_ii_tpu.ops.ring_attention import (
    ring_attention as j_ring_attention,
)
from incremental_multimodal_medical_learning_ii_tpu.parallel.sp import create_mesh_sp as j_mesh_sp
from incremental_multimodal_medical_learning_ii_torch.ops import ring_attention as t_ring
from incremental_multimodal_medical_learning_ii_torch.parallel import mesh as tmesh

from torch_port_helpers import assert_parity, ppermute_on_rank, ring_on_rank

RING_ATOL = 1e-5  # tests/test_sp.py:62-80
N_SEQ = 4


def _inputs(seed, b, nh, s, hd, valid_rows):
    rng = np.random.default_rng(seed)
    q, k, v, w = (rng.standard_normal((b, nh, s, hd)).astype(np.float32) for _ in range(4))
    valid = np.zeros((b, s), np.int32)
    for row, n_valid in enumerate(valid_rows):
        valid[row, :n_valid] = 1
    return q, k, v, valid, w


CASES = {
    # padding crosses a chunk boundary (chunks of 8)
    "ragged": _inputs(1, 2, 3, 32, 8, (32, 20)),
    # chunks 1..3 of row 0 are all padding: they must contribute exactly 0
    "masked chunks": _inputs(2, 1, 2, 32, 8, (5,)),
}


def _dense(q, k, v, valid):
    """softmax(QK^T / sqrt(d)) V over the valid keys, in torch (float64)."""
    q, k, v = (torch.from_numpy(a).double().requires_grad_(True) for a in (q, k, v))
    scores = torch.einsum("bnqd,bnkd->bnqk", q, k) / np.sqrt(q.shape[-1])
    scores = scores.masked_fill(~torch.from_numpy(valid != 0)[:, None, None, :], -torch.inf)
    return torch.einsum("bnqk,bnkd->bnqd", torch.softmax(scores, -1), v), (q, k, v)


@pytest.fixture(scope="module")
def ranks():
    return tmesh.spawn_ranks(ring_on_rank, (1, N_SEQ), "cpu", CASES)


@pytest.fixture(scope="module")
def two_ranks():
    return tmesh.spawn_ranks(ppermute_on_rank, 2, "cpu")


def _whole(ranks, name, key):
    return np.concatenate([r[name][key] for r in ranks], axis=2)


@pytest.mark.parametrize("name", list(CASES))
def test_ring_matches_dense_attention(ranks, name):
    q, k, v, valid, w = CASES[name]
    ref, leaves = _dense(q, k, v, valid)
    assert_parity(f"ring {name} vs dense", _whole(ranks, name, "out"), ref.detach().numpy(),
                  RING_ATOL)
    (ref * torch.from_numpy(w).double()).sum().backward()
    for key, leaf in zip(("dq", "dk", "dv"), leaves):
        assert_parity(f"ring {name} {key} vs dense", _whole(ranks, name, key), leaf.grad.numpy(),
                      RING_ATOL)


@pytest.mark.parametrize("name", list(CASES))
def test_ring_matches_the_jax_ring(ranks, name):
    """The JAX ring on a (1, 4) CPU mesh, the same chunks and hop order."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    q, k, v, valid, _ = CASES[name]
    hd = q.shape[-1]
    fn = shard_map(
        lambda *a: j_ring_attention(*a, "seq", N_SEQ, sm_scale=1.0 / float(np.sqrt(hd))),
        mesh=j_mesh_sp(1, N_SEQ),
        in_specs=(P(None, None, "seq", None),) * 3 + (P(None, "seq"),),
        out_specs=P(None, None, "seq", None), check_vma=False)
    ref = np.asarray(jax.jit(fn)(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), valid))
    assert_parity(f"ring {name} vs the JAX ring", _whole(ranks, name, "out"), ref, RING_ATOL)


def test_ring_keeps_the_jax_constants():
    from incremental_multimodal_medical_learning_ii_tpu.ops import ring_attention as j_ring

    assert t_ring._NEG == j_ring._NEG


def test_two_d_view_lines(ranks):
    """Rank d * inner + i: the seq lines are rows, the data lines columns."""
    for rank, r in enumerate(ranks):
        d, i = divmod(rank, N_SEQ // 2)
        assert r["view"]["seq"] == (tuple(d * 2 + j for j in range(2)), i, 2)
        assert r["view"]["data"] == (tuple(j * 2 + i for j in range(2)), d, 2)
        assert r["transport"] == "gloo isend/irecv"


def test_ppermute_and_its_gradient(two_ranks):
    """``ppermute(x, shift)`` gives each rank the tensor of the rank
    ``shift`` behind (zeros past an end without ``wrap``); its gradient is
    the cotangent hopped back the other way, as JAX transposes it."""
    w = [np.arange(6.0).reshape(2, 3) * 10 ** r for r in range(2)]
    for (shift, wrap) in ((1, True), (-1, True), (1, False), (-1, False)):
        for r in range(2):
            got = two_ranks[r][(shift, wrap)]
            src, dst = r - shift, r + shift
            has_src, has_dst = wrap or 0 <= src < 2, wrap or 0 <= dst < 2
            want_y = np.full((2, 3), float(src % 2 + 1)) if has_src else np.zeros((2, 3))
            want_g = w[dst % 2] if has_dst else np.zeros((2, 3))
            np.testing.assert_array_equal(got["y"], want_y, err_msg=f"{shift} {wrap} {r}")
            np.testing.assert_array_equal(got["grad"], want_g, err_msg=f"{shift} {wrap} {r}")
    np.testing.assert_array_equal(two_ranks[0]["int"], [8, 8, 8])
    np.testing.assert_array_equal(two_ranks[1]["int"], [7, 7, 7])


def test_psum_and_pvary_gradients(two_ranks):
    """``psum``: the sum on every rank, the gradient passed through;
    ``pvary``: the identity, the gradient summed over the ranks."""
    for r in range(2):
        total, grad = two_ranks[r]["psum"]
        np.testing.assert_array_equal(total, [3.0, 3.0])
        np.testing.assert_array_equal(grad, [r + 2.0, r + 2.0])
        np.testing.assert_array_equal(two_ranks[r]["pvary"], [5.0, 5.0])


def test_mesh_shapes_raise_as_jax_does():
    n = len(jax.devices())
    with pytest.raises(ValueError) as jerr:
        j_mesh_sp(2, n)
    with pytest.raises(ValueError) as terr:
        tmesh.create_mesh((2, n), devices=["cpu"] * n, axis_names=("data", "seq"))
    assert str(terr.value) == str(jerr.value) == f"need {2 * n} devices, have {n}"
    with pytest.raises(ValueError, match="spawn_ranks"):
        tmesh.create_mesh((2, 2), devices="cpu", axis_names=("data", "seq"))
    one = tmesh.Mesh(rank=0, size=4, device=torch.device("cpu"), backend="gloo", group=None)
    assert one.shape == {"data": 4} and one.along("data") is one
    with pytest.raises(KeyError, match="no axis 'seq'"):
        one.along("seq")
