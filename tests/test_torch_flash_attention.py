"""Port ops/flash_attention.py: the plain version (mha_reference), which
the CUDA kernel is held to on the card, against the JAX library's Pallas
flash-attention kernel run in TPU interpret mode on the CPU."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu.flash_attention import SegmentIds
from jax.experimental.pallas.ops.tpu.flash_attention import flash_attention as jax_flash

from incremental_multimodal_medical_learning_ii_torch.ops.flash_attention import (
    MASK_VALUE,
    flash_attention,
    mha_reference,
)

from torch_port_helpers import assert_parity

ATOL = 1e-5  # fp32 online softmax vs one-pass softmax: summation order only


def _case(seed, b, h, s, hd, lengths):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, h, s, hd)).astype(np.float32) for _ in range(3))
    seg = (np.arange(s)[None, :] < np.asarray(lengths)[:, None]).astype(np.int32)
    return q, k, v, seg


@pytest.mark.parametrize("b,h,s,hd,lengths", [
    (2, 2, 256, 64, [256, 200]),  # one row padded from 200
    (1, 2, 128, 128, [77]),       # hd 128, as the JAX flash test's heads
])
def test_plain_version_matches_pallas_interpret(b, h, s, hd, lengths):
    q, k, v, seg = _case(b * s + hd, b, h, s, hd, lengths)
    scale = 1.0 / float(np.sqrt(hd))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   segment_ids=SegmentIds(q=jnp.asarray(seg), kv=jnp.asarray(seg)),
                                   sm_scale=scale))
    t = [torch.from_numpy(a) for a in (q, k, v, seg)]
    ours = mha_reference(t[0], t[1], t[2], t[3], t[3], scale).numpy()
    # every position, padded query rows included: both attend padding only
    assert_parity(f"mha_reference {(b, h, s, hd)} vs pallas flash (interpret)", ours, ref, ATOL)
    # the wrapper on CPU tensors is exactly the plain version
    np.testing.assert_array_equal(flash_attention(t[0], t[1], t[2], t[3], t[3], scale).numpy(), ours)


def test_segment_semantics():
    """A query attends only keys of its segment; a query whose segment no
    key shares averages every key (the finite mask value, as on the TPU);
    bf16 inputs give a bf16 result computed in fp32."""
    q, k, v, seg = _case(3, 1, 1, 6, 64, [4])
    t = [torch.from_numpy(a) for a in (q, k, v)]
    seg_q = torch.from_numpy(seg)
    out = mha_reference(*t, seg_q, seg_q, 0.125).numpy()
    logits = q[0, 0] @ k[0, 0].T * 0.125
    w = np.exp(logits[:4, :4] - logits[:4, :4].max(-1, keepdims=True))
    np.testing.assert_allclose(out[0, 0, :4], (w / w.sum(-1, keepdims=True)) @ v[0, 0, :4],
                               atol=1e-6)
    lonely = mha_reference(*t, torch.full((1, 6), 7), seg_q, 0.125).numpy()
    np.testing.assert_allclose(lonely[0, 0], np.broadcast_to(v[0, 0].mean(0), (6, 64)), atol=1e-6)
    assert MASK_VALUE == -0.7 * float(np.finfo(np.float32).max)
    half = mha_reference(*(x.bfloat16() for x in t), seg_q, seg_q, 0.125)
    assert half.dtype == torch.bfloat16
    ref = mha_reference(*(x.bfloat16().float() for x in t), seg_q, seg_q, 0.125)
    np.testing.assert_array_equal(half.float().numpy(), ref.bfloat16().float().numpy())
