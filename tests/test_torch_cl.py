"""Port engine/cl.py (the myCL/profCL weight reset) against the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incremental_multimodal_medical_learning_ii_tpu.engine.cl import weight_reset as jreset
from incremental_multimodal_medical_learning_ii_tpu.models.adapters import AdapterPair
from incremental_multimodal_medical_learning_ii_torch.convert import adapter_params_from_jax
from incremental_multimodal_medical_learning_ii_torch.engine.cl import weight_reset as treset

from torch_port_helpers import assert_parity, one_torch_thread, to_numpy_tree  # noqa: F401

ATOL = 1e-6


def _pair_of_trees(rng, shared):
    pair = AdapterPair(kind="mlp", shared=shared, use_image=True, use_text=True)
    snap = to_numpy_tree(pair.init(jax.random.PRNGKey(3)))
    # an update of Adam's shape: most deltas near one scale, a few larger,
    # some exactly zero
    params = jax.tree_util.tree_map(
        lambda a: (a + np.where(rng.random(a.shape) < 0.1, 0.0,
                                rng.normal(size=a.shape) * 1e-4)).astype(np.float32), snap)
    return params, snap


@pytest.mark.parametrize("applications", [1, 2])
@pytest.mark.parametrize("threshold", [0.0, 0.01, 0.3, 1.0])
def test_weight_reset_matches_jax(rng, applications, threshold):
    params, snap = _pair_of_trees(rng, shared=applications == 2)
    jp, jn_reset, jn_upd = jreset(
        jax.tree_util.tree_map(jnp.asarray, params), jax.tree_util.tree_map(jnp.asarray, snap),
        jnp.float32(threshold), applications=applications)
    tp, tn_reset, tn_upd = treset(adapter_params_from_jax(params), adapter_params_from_jax(snap),
                                  torch.tensor(threshold, dtype=torch.float32),
                                  applications=applications)
    assert tn_reset.dtype == torch.int32 and tn_upd.dtype == torch.int32
    assert int(tn_reset) == int(jn_reset) and int(tn_upd) == int(jn_upd)
    n_weights = sum(np.size(a) for a in jax.tree_util.tree_leaves(params))
    assert int(tn_reset) + int(tn_upd) == applications * n_weights
    if threshold == 0.0:
        assert int(tn_reset) == 0  # strict <: a zero cutoff resets nothing
    want = adapter_params_from_jax(to_numpy_tree(jp))
    for k in want:
        assert_parity(f"weight_reset {k} x{applications} t={threshold}",
                      tp[k].numpy(), want[k].numpy(), ATOL)


def test_weight_reset_is_pure_and_python_float_threshold(rng):
    params, snap = _pair_of_trees(rng, shared=False)
    tparams, tsnap = adapter_params_from_jax(params), adapter_params_from_jax(snap)
    before = {k: v.clone() for k, v in tparams.items()}
    out, n_reset, _ = treset(tparams, tsnap, 0.05)
    for k in before:
        assert torch.equal(tparams[k], before[k])  # inputs untouched
    out32, n32, _ = treset(tparams, tsnap, torch.tensor(0.05))
    assert int(n_reset) == int(n32)
    assert all(torch.equal(out[k], out32[k]) for k in out)
