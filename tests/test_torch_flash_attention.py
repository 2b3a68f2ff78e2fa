"""Port ops/flash_attention.py: the plain version (mha_reference), which
the CUDA kernel is held to on the card, against the JAX library's Pallas
flash-attention kernel run in TPU interpret mode on the CPU; the CPU
path's gradients against ``jax.grad`` through that kernel; and the bf16
kernel's tile-skipping predicate, shown exact on a blocked emulation of
its schedule."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu.flash_attention import SegmentIds
from jax.experimental.pallas.ops.tpu.flash_attention import flash_attention as jax_flash

from incremental_multimodal_medical_learning_ii_torch.ops.flash_attention import (
    BLOCK,
    MASK_VALUE,
    flash_attention,
    key_tiles_needed,
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


def test_cpu_path_gradients_match_jax():
    """On CPU tensors the wrapper differentiates (through mha_reference),
    as the JAX library kernel does through its custom VJP: the gradients
    of sum(out * w) at (1, 2, 128, 64), one row padded, match ``jax.grad``
    through the Pallas kernel in interpret mode.  This is what a backward
    kernel must match."""
    q, k, v, seg = _case(11, 1, 2, 128, 64, [100])
    w = np.random.default_rng(12).normal(size=q.shape).astype(np.float32)
    scale = 0.125

    def jax_loss(q_, k_, v_):
        out = jax_flash(q_, k_, v_, segment_ids=SegmentIds(q=jnp.asarray(seg), kv=jnp.asarray(seg)),
                        sm_scale=scale)
        return (out * jnp.asarray(w)).sum()

    with pltpu.force_tpu_interpret_mode():
        ref = jax.grad(jax_loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    t = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    s = torch.from_numpy(seg)
    (flash_attention(*t, s, s, scale) * torch.from_numpy(w)).sum().backward()
    for name, ours, theirs in zip("qkv", t, ref):
        assert_parity(f"flash_attention CPU d{name} vs jax.grad (pallas interpret)",
                      ours.grad.numpy(), np.asarray(theirs), ATOL)


def _blocked_attention(q, k, v, seg_q, seg_kv, scale, needed=None):
    """The bf16 kernel's schedule in fp32: 64-query blocks walk 64-key
    tiles in order with an online softmax (running max m, sum l, deferred
    normalisation); keys past S are -inf, a segment mismatch adds
    MASK_VALUE.  ``needed`` (B, n, n) skips the tiles where it is False."""
    b, h, s, _ = q.shape
    out = torch.zeros_like(q)
    for bi in range(b):
        for i0 in range(0, s, BLOCK):
            qi = q[bi, :, i0:i0 + BLOCK]
            m = torch.full(qi.shape[:2] + (1,), -np.inf)
            l = torch.zeros(qi.shape[:2] + (1,))
            acc = torch.zeros_like(qi)
            for j0 in range(0, s, BLOCK):
                if needed is not None and not needed[bi, i0 // BLOCK, j0 // BLOCK]:
                    continue
                logits = qi @ k[bi, :, j0:j0 + BLOCK].transpose(-1, -2) * scale
                same = seg_q[bi, i0:i0 + BLOCK, None] == seg_kv[bi, None, j0:j0 + BLOCK]
                logits = logits + torch.where(same, 0.0, MASK_VALUE)
                mx = torch.maximum(m, logits.amax(-1, keepdim=True))
                alpha = torch.where(mx == m, 1.0, torch.exp(m - mx))
                p = torch.exp(logits - mx)
                l = l * alpha + p.sum(-1, keepdim=True)
                acc = acc * alpha + p @ v[bi, :, j0:j0 + BLOCK]
                m = mx
            out[bi, :, i0:i0 + BLOCK] = acc / torch.where(l == 0, 1.0, l)
    return out


@pytest.mark.parametrize("s,hd,lengths", [
    (512, 64, [1, 63, 64, 65, 300, 512]),  # every edge of a 64-row block
    (200, 64, [200, 1, 123]),              # a ragged last tile
    (512, 64, [512, 512]),                 # nothing to skip
    (256, 128, [256, 200, 130, 17]),       # hd 128
])
def test_tile_skipping_is_exact(s, hd, lengths):
    """Skipping the key tiles that key_tiles_needed rules out (self
    segments: BERT's key-padding masks) changes no bit of a blocked online
    softmax, and both agree with mha_reference (and the Pallas kernel
    through it, test above)."""
    q, k, v, seg = _case(s + len(lengths), len(lengths), 2, s, hd, lengths)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    seg = torch.from_numpy(seg)
    needed = key_tiles_needed(seg, seg, self_segments=True)
    scale = 1.0 / float(np.sqrt(hd))
    skipping = _blocked_attention(*t, seg, seg, scale, needed)
    dense = _blocked_attention(*t, seg, seg, scale)
    assert torch.equal(skipping, dense)
    assert_parity(f"blocked online softmax with skipping, S={s} hd={hd} {lengths} vs mha_reference",
                  skipping.numpy(), mha_reference(*t, seg, seg, scale).numpy(), ATOL)
    if lengths == [512, 512]:
        assert bool(needed.all())
    else:
        assert not bool(needed.all())


def test_key_tiles_needed_predicate():
    """Disjoint [min, max] segment ranges skip; different q and kv arrays
    never do (a query that matches no key averages all of them); positions
    past S do not count."""
    seg = torch.tensor([[1] * 100 + [0] * 100, [1] * 200])
    need = key_tiles_needed(seg, seg, self_segments=True)
    assert need.shape == (2, 4, 4)
    # row 0: blocks 0 (ids 1), 1 (1 and 0), 2 and 3 (0): block 0 skips tiles 2, 3
    expected = torch.tensor([[1, 1, 0, 0], [1, 1, 1, 1], [0, 1, 1, 1], [0, 1, 1, 1]], dtype=torch.bool)
    assert torch.equal(need[0], expected)
    assert bool(need[1].all())
    assert bool(key_tiles_needed(seg, seg.clone(), self_segments=False).all())


def test_self_segments_detection():
    """The wrapper skips only when q and kv carry one array: the same
    tensor, or the same memory with the same shape and strides; a clone
    turns skipping off (the bit-exactness check on the card uses that)."""
    from incremental_multimodal_medical_learning_ii_torch.ops.flash_attention import _same_array

    seg = torch.ones(2, 8, dtype=torch.int32)
    assert _same_array(seg, seg)
    assert _same_array(seg, seg.view(2, 8))
    assert not _same_array(seg, seg.clone())
    assert not _same_array(seg, seg.t())


def test_computed_tiles_is_for_the_bf16_kernel_only():
    """The tile count comes from the bf16 kernel on the card: on CPU
    tensors, where the plain version computes every pair, the wrapper
    refuses the counter instead of leaving it at zero."""
    q, k, v, seg = _case(5, 1, 2, 64, 64, [40])
    t = [torch.from_numpy(a) for a in (q, k, v, seg)]
    with pytest.raises(ValueError, match="computed_tiles"):
        flash_attention(t[0], t[1], t[2], t[3], t[3], 0.125,
                        computed_tiles=torch.zeros(1, dtype=torch.int32))
    np.testing.assert_array_equal(flash_attention(t[0], t[1], t[2], t[3], t[3], 0.125).numpy(),
                                  mha_reference(t[0], t[1], t[2], t[3], t[3], 0.125).numpy())
