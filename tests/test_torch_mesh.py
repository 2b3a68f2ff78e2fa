"""``parallel/mesh.py`` (ranks over ``torch.distributed``) and K1-mesh,
``ops/fused_cosine.py::pairwise_cosine_sharded``, on two gloo ranks on the
CPU, against the JAX package's ``parallel/mesh.py`` and
``pallas_pairwise_cosine_sharded`` on ``create_mesh(2)`` (the CPU mesh of
conftest.py, the kernel in interpret mode)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incremental_multimodal_medical_learning_ii_tpu.ops.cosine import pairwise_cosine as j_cosine
from incremental_multimodal_medical_learning_ii_tpu.ops.pallas_cosine import (
    pallas_pairwise_cosine_sharded,
)
from incremental_multimodal_medical_learning_ii_tpu.parallel import mesh as jmesh
from incremental_multimodal_medical_learning_ii_torch.parallel import mesh as tmesh

from torch_port_helpers import fail_on_rank_one, mesh_primitives_on_rank

COSINE_ATOL = 1e-5  # tests/test_pallas_cosine.py's bar for the sharded kernel


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(27)
    x = rng.normal(size=(128, 128)).astype(np.float32)
    t = rng.normal(size=(10, 128)).astype(np.float32)
    ragged = rng.normal(size=(127, 128)).astype(np.float32)
    return x, t, ragged


@pytest.fixture(scope="module")
def ranks(inputs):
    return tmesh.spawn_ranks(mesh_primitives_on_rank, 2, "cpu", *inputs)


def _mesh(rank, size):
    return tmesh.Mesh(rank=rank, size=size, device=torch.device("cpu"), backend="gloo", group=None)


def test_create_mesh_raises_as_jax_does(monkeypatch):
    n = len(jmesh.create_mesh().devices)
    with pytest.raises(ValueError) as jerr:
        jmesh.create_mesh(n + 1)
    with pytest.raises(ValueError) as terr:
        tmesh.create_mesh(n + 1, devices=["cpu"] * n)
    assert str(terr.value) == str(jerr.value) == f"need {n + 1} devices, have {n}"
    # on the card: the visible cards, never fewer ranks than asked for
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    for make in (lambda: tmesh.create_mesh(3), lambda: tmesh.spawn_ranks(print, 3, "cuda")):
        with pytest.raises(ValueError, match="need 3 devices, have 2"):
            make()
    with pytest.raises(ValueError, match="NCCL needs one card per rank"):
        tmesh.spawn_ranks(print, 2, ["cuda:0", "cuda:0"], backend="nccl")
    with pytest.raises(ValueError, match="spawn_ranks"):
        tmesh.create_mesh(2, devices=["cpu", "cpu"])
    assert tmesh.current_mesh() is None


def test_pad_to_multiple_and_the_axis_name():
    for n in range(0, 40):
        for k in (1, 2, 3, 8):
            assert tmesh.pad_to_multiple(n, k) == jmesh.pad_to_multiple(n, k)
    assert tmesh.DATA_AXIS == jmesh.DATA_AXIS


@pytest.mark.parametrize("size", [1, 2, 3, 8])
def test_shards_partition_the_rows_rank_major(size):
    for n in (0, 1, 7, 32, 97, 1023, 1024):
        bounds = [tmesh.shard_bounds(_mesh(r, size), n) for r in range(size)]
        assert bounds[0][0] == 0 and bounds[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
        assert all(stop - start <= -(-n // size) for start, stop in bounds)


def test_rows_round_trip_and_collectives(ranks, inputs):
    x, _, ragged = inputs
    assert [r["rows"] for r in ranks] == [(64, 64), (64, 63)]
    for r in ranks:
        np.testing.assert_array_equal(r["even"], x)
        np.testing.assert_array_equal(r["ragged"], ragged)
        np.testing.assert_array_equal(r["sum"], [3.0, 3.0, 3.0])
        np.testing.assert_array_equal(r["replicated"], [0.0, 0.0])  # rank 0's
        assert "its shard of 128 is 64" in r["wrong_shard"]


def test_sharded_cosine_matches_the_jax_sharded_kernel(ranks, inputs):
    x, t, _ = inputs
    ref = np.asarray(pallas_pairwise_cosine_sharded(
        jmesh.create_mesh(2), jnp.asarray(x), jnp.asarray(t), block_b=32, interpret=True))
    for r in ranks:
        np.testing.assert_allclose(r["cosine"], ref, atol=COSINE_ATOL, rtol=0)
        assert r["calls"] == 0  # the CPU takes the plain version: no kernel call counted


def test_sharded_cosine_with_a_ragged_last_shard(ranks, inputs):
    _, t, ragged = inputs
    ref = np.asarray(j_cosine(jnp.asarray(ragged), jnp.asarray(t)))
    for r in ranks:
        assert r["cosine_ragged"].shape == (127, 10)
        np.testing.assert_allclose(r["cosine_ragged"], ref, atol=COSINE_ATOL, rtol=0)


def test_a_failing_rank_fails_the_launch_with_its_traceback():
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed") as err:
        tmesh.spawn_ranks(fail_on_rank_one, 2, "cpu")
    assert "rank one gives up" in str(err.value) and "Traceback" in str(err.value)


def test_one_rank_mesh_in_process():
    """``create_mesh(1)`` starts a group of one in this process: its
    gather is the identity and ``current_mesh`` returns it until it ends."""
    mesh = tmesh.create_mesh(1, devices="cpu")
    try:
        assert (mesh.rank, mesh.size, mesh.backend) == (0, 1, "gloo")
        assert tmesh.create_mesh(1) is mesh is tmesh.current_mesh()
        x = torch.arange(12.0).reshape(4, 3)
        assert torch.equal(tmesh.gather_rows(mesh, tmesh.batch_rows(mesh, x), 4), x)
        with pytest.raises(ValueError, match="need 2 devices, have 1 ranks"):
            tmesh.create_mesh(2)
    finally:
        tmesh.destroy_mesh()
    assert tmesh.current_mesh() is None
