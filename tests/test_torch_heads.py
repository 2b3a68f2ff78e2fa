"""Port models/heads.py (stacked multitask heads) against the JAX package,
with the JAX parameters carried across by ``params_from_jax``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incremental_multimodal_medical_learning_ii_tpu.models import heads as jh
from incremental_multimodal_medical_learning_ii_torch.convert import params_from_jax, params_to_jax
from incremental_multimodal_medical_learning_ii_torch.models import heads as th

from torch_port_helpers import assert_parity, to_numpy_tree

HEAD_ATOL = 1e-6  # one or two fp32 products of width <= 64


@pytest.mark.parametrize("hidden", [None, 24])
def test_multitask_head_matches_jax(rng, hidden):
    tree = to_numpy_tree(jh.init_multitask_head(jax.random.PRNGKey(0), 64, 3, 4, hidden_dim=hidden))
    if hidden is not None:  # non-trivial frozen BN statistics
        for name, lo in (("bn_scale", 0.5), ("bn_var", 0.5)):
            tree[name] = (rng.random((4, hidden)) + lo).astype(np.float32)
        for name in ("bn_bias", "bn_mean"):
            tree[name] = (rng.normal(size=(4, hidden)) * 0.1).astype(np.float32)
    head = params_from_jax(tree)
    assert isinstance(head, th.MultitaskHead) and head.mlp == (hidden is not None)
    x = rng.normal(size=(5, 64)).astype(np.float32)
    ref = np.asarray(jh.multitask_head_forward(tree, jnp.asarray(x)))
    with torch.no_grad():
        ours = th.multitask_head_forward(head, torch.from_numpy(x)).numpy()
    assert ours.shape == ref.shape == (5, 3, 4)  # (B, num_classes, num_tasks)
    assert_parity(f"multitask head hidden={hidden}", ours, ref, HEAD_ATOL)
    back = params_to_jax(head)
    assert set(back) == set(tree)
    for k in tree:
        np.testing.assert_array_equal(back[k], tree[k])
    # the port's own init: the JAX structure and nn.Linear's bounds
    own = th.init_multitask_head(torch.Generator().manual_seed(0), 64, 3, 4, hidden_dim=hidden)
    assert {k: tuple(v.shape) for k, v in params_to_jax(own).items()} == {
        k: v.shape for k, v in tree.items()}
    first = own.w if hidden is None else own.w1
    assert float(first.abs().max()) <= 1.0 / np.sqrt(64)
    assert own(torch.from_numpy(x)).shape == (5, 3, 4)
