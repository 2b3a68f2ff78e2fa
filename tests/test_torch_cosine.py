"""Port ops/cosine.py + ops/fused_cosine.py against the JAX package's
ops/cosine.py and its Pallas kernel (interpret mode)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incremental_multimodal_medical_learning_ii_tpu.ops import cosine as jcos
from incremental_multimodal_medical_learning_ii_tpu.ops.pallas_cosine import (
    pallas_pairwise_cosine,
)
from incremental_multimodal_medical_learning_ii_torch.ops import cosine as tcos
from incremental_multimodal_medical_learning_ii_torch.ops.fused_cosine import (
    fused_pairwise_cosine,
)

from torch_port_helpers import assert_parity

# fp32 dot of unit vectors over D=128: summation order differs between the
# frameworks, a few float32 ulps of 1.0 at most
ATOL = 1e-6


def _operands(rng, b, t, zero_rows=()):
    x = rng.normal(size=(b, 128)).astype(np.float32)
    bank = rng.normal(size=(t, 128)).astype(np.float32) * 3.0
    for r in zero_rows:
        x[r % b] = 0.0
        bank[r % t] = 0.0
    return x, bank


@pytest.mark.parametrize(
    "b,t,zero_rows",
    [(512, 128, ()), (16, 10, ()), (37, 23, (0, 5)), (6144 // 8, 40, (3,)), (1, 1, ())],
)
def test_pairwise_cosine_matches_jax_and_pallas(rng, b, t, zero_rows):
    x, bank = _operands(rng, b, t, zero_rows)
    ours = tcos.pairwise_cosine(torch.from_numpy(x), torch.from_numpy(bank)).numpy()
    ref = np.asarray(jcos.pairwise_cosine(jnp.asarray(x), jnp.asarray(bank)))
    pal = np.asarray(pallas_pairwise_cosine(jnp.asarray(x), jnp.asarray(bank), interpret=True))
    assert ours.shape == ref.shape == pal.shape == (b, t)
    assert_parity(f"pairwise_cosine {b}x{t} vs jax", ours, ref, ATOL)
    assert_parity(f"pairwise_cosine {b}x{t} vs pallas", ours, pal, ATOL)
    for r in zero_rows:  # zero rows score 0, not NaN
        assert np.all(ours[r % b] == 0.0) and np.all(ours[:, r % t] == 0.0)
    # the kernel's wrapper on CPU tensors is exactly the plain version
    fused = fused_pairwise_cosine(torch.from_numpy(x), torch.from_numpy(bank)).numpy()
    np.testing.assert_array_equal(fused, ours)


def test_l2_normalize_eps_semantics():
    """x / max(||x||, 1e-8): a vector below the eps is scaled by 1/eps, as
    in the JAX package — F.normalize (eps 1e-12) would give a unit vector."""
    x = np.zeros((3, 128), np.float32)
    x[0, 0] = 1e-9
    x[1, :] = 0.5
    ours = tcos.l2_normalize(torch.from_numpy(x)).numpy()
    ref = np.asarray(jcos.l2_normalize(jnp.asarray(x)))
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=0)
    assert ours[0, 0] == pytest.approx(0.1, rel=1e-5)
    assert np.all(ours[2] == 0.0)


def test_cosine_to_banks_and_masked_mean(rng):
    x = rng.normal(size=(9, 128)).astype(np.float32)
    banks = rng.normal(size=(5, 6, 128)).astype(np.float32)
    count = np.array([6, 1, 3, 0, 4], np.int32)
    for c, n in enumerate(count):
        banks[c, n:] = 0.0
    ours = tcos.cosine_to_banks(torch.from_numpy(x), torch.from_numpy(banks)).numpy()
    ref = np.asarray(jcos.cosine_to_banks(jnp.asarray(x), jnp.asarray(banks)))
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=0)
    mm = tcos.masked_mean(torch.from_numpy(banks), torch.from_numpy(count)).numpy()
    ref_mm = np.asarray(jcos.masked_mean(jnp.asarray(banks), jnp.asarray(count)))
    np.testing.assert_allclose(mm, ref_mm, atol=1e-7, rtol=0)


def test_fused_wrapper_empty_batch():
    bank = torch.ones(10, 128)
    assert fused_pairwise_cosine(torch.zeros(0, 128), bank).shape == (0, 10)


@pytest.mark.parametrize("operand", [0, 1])
def test_fused_cosine_refuses_gradients_like_jax(rng, operand):
    """No backward: where ``jax.grad`` through the Pallas kernel fails,
    the wrapper raises (on every device) instead of returning a result cut
    from the autograd graph; under ``torch.no_grad()`` it scores as the
    kernel does."""
    x, bank = _operands(rng, 16, 10)
    with pytest.raises(ValueError, match="Linearization failed"):
        jax.grad(lambda a, b: pallas_pairwise_cosine(a, b, interpret=True).sum(),
                 argnums=operand)(jnp.asarray(x), jnp.asarray(bank))
    ours = [torch.from_numpy(x), torch.from_numpy(bank)]
    ours[operand].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        fused_pairwise_cosine(*ours)
    with torch.no_grad():
        got = fused_pairwise_cosine(*ours)
    assert not got.requires_grad
    ref = np.asarray(pallas_pairwise_cosine(jnp.asarray(x), jnp.asarray(bank), interpret=True))
    assert_parity(f"fused_pairwise_cosine under no_grad (operand {operand} requires grad)",
                  got.numpy(), ref, ATOL)


@pytest.mark.parametrize("rows", [1, 255, 256, 257, 300, 700])
def test_bank_chunking_arithmetic(rng, rows):
    """A bank of more than 256 rows goes to the kernel in chunks of at most
    256 rows, each into its column slice: the chunk loop, run with the
    plain version in place of a launch, rebuilds the whole product."""
    from incremental_multimodal_medical_learning_ii_torch.ops.fused_cosine import (
        MAX_BANK_ROWS,
        scores_in_chunks,
    )

    x, bank = (torch.from_numpy(a) for a in _operands(rng, 9, rows))
    chunks = []

    def plain_launch(x_, t_, out_cols):
        assert t_.shape[0] <= MAX_BANK_ROWS and out_cols.stride(0) == rows
        chunks.append(t_.shape[0])
        out_cols.copy_(tcos.pairwise_cosine(x_, t_))

    out = scores_in_chunks(x, bank, torch.full((9, rows), float("nan")), plain_launch)
    assert chunks == [min(MAX_BANK_ROWS, rows - s) for s in range(0, rows, MAX_BANK_ROWS)]
    # one product against several: the matmul may block the sum otherwise
    np.testing.assert_allclose(out.numpy(), tcos.pairwise_cosine(x, bank).numpy(), atol=ATOL,
                               rtol=0)
