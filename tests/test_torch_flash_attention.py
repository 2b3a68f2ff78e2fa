"""Port ops/flash_attention.py: the plain version (mha_reference), which
the CUDA kernel is held to on the card, against the JAX library's Pallas
flash-attention kernel run in TPU interpret mode on the CPU; the CPU
path's gradients against ``jax.grad`` through that kernel; and the
kernels' tile-skipping predicate, shown exact on an emulation of the fp32
kernel's walk over the key tiles."""

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
    """On CPU tensors the wrapper differentiates (through the plain forward
    and backward, ``flash_attention_bwd_reference``), as the JAX library
    kernel does through its custom VJP: the gradients of sum(out * w) at
    (1, 2, 128, 64), one row padded, match ``jax.grad`` through the Pallas
    kernel in interpret mode, as K3b's must on the card."""
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


def _blocked_attention(q, k, v, seg_q, seg_kv, scale, self_segments):
    """The fp32 kernel's walk, in fp32, batched over batch rows, heads and
    query blocks: each 64-query block (half a CTA) visits the 64-key tiles
    in order and computes those that ``key_tiles_needed`` keeps (every tile
    with two id arrays; the CTA loads a tile that either half needs, which
    changes no arithmetic).  A computed tile takes the kernel's steps: the
    logit scaled, then the mask value added where the segments differ; keys
    past S at -inf; the running max m, alpha = exp(m - mx) with no special
    case, the row sum l = rowsum(p) + alpha * l, O = O * alpha + p v; the
    normalisation deferred to the end, a row with l = 0 left at zero.  A
    block that skips a tile keeps its m, l and O as they were."""
    b, h, s, hd = q.shape
    needed = key_tiles_needed(seg_q, seg_kv, self_segments)  # (B, n, n)
    n = needed.shape[1]
    pad = n * BLOCK - s

    def blocks(x):  # (B, nh, S, hd) -> (B, nh, n, 64, hd), rows past S zero
        return torch.nn.functional.pad(x, (0, 0, 0, pad)).reshape(b, h, n, BLOCK, hd)

    qb, kb, vb = blocks(q), blocks(k), blocks(v)
    sq = torch.nn.functional.pad(seg_q, (0, pad)).reshape(b, 1, n, BLOCK, 1)
    sk = torch.nn.functional.pad(seg_kv, (0, pad)).reshape(b, n, BLOCK)
    inside = (torch.arange(n * BLOCK) < s).reshape(n, BLOCK)
    m = torch.full((b, h, n, BLOCK, 1), -np.inf)
    l = torch.zeros((b, h, n, BLOCK, 1))
    acc = torch.zeros_like(qb)
    for j in range(n):
        logits = (qb @ kb[:, :, j, None].transpose(-1, -2)) * scale  # (B, nh, n, 64, 64)
        logits = logits + torch.where(sq == sk[:, None, None, j, None, :], 0.0, MASK_VALUE)
        logits = torch.where(inside[j], logits, -np.inf)
        mx = torch.maximum(m, logits.amax(-1, keepdim=True))
        alpha = torch.exp(m - mx)
        p = torch.exp(logits - mx)
        keep = needed[:, None, :, j, None, None]  # (B, 1, n, 1, 1): the block computes tile j
        l = torch.where(keep, p.sum(-1, keepdim=True) + alpha * l, l)
        acc = torch.where(keep, acc * alpha + p @ vb[:, :, j, None], acc)
        m = torch.where(keep, mx, m)
    out = acc / torch.where(l == 0, 1.0, l)
    return out.reshape(b, h, n * BLOCK, hd)[:, :, :s]


@pytest.mark.parametrize("s,hd,lengths", [
    (512, 64, [1, 63, 64, 65, 300, 512]),  # every edge of a 64-row block
    (200, 64, [200, 1, 123]),              # a ragged last tile
    (512, 64, [512, 512]),                 # nothing to skip
    (256, 128, [256, 200, 130, 17]),       # hd 128, also held to the Pallas kernel
    (200, 64, [200, 150]),                 # lonely queries: two id arrays, nothing skipped
])
def test_tile_skipping_is_exact(s, hd, lengths):
    """The fp32 kernel's walk skipping the key tiles that key_tiles_needed
    rules out (one id array: BERT's key-padding masks) changes no bit of
    its result against the same walk computing every tile, and both agree
    with mha_reference (and, at hd 128, with the Pallas kernel in interpret
    mode).  With two id arrays (queries whose segment no key shares: row 1
    of kv is one id throughout) the walk skips nothing and each lonely
    query averages every key, as the plain version says."""
    q, k, v, seg = _case(s + len(lengths), len(lengths), 2, s, hd, lengths)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    seg_q = torch.from_numpy(seg)
    lonely = lengths == [200, 150]
    seg_kv = seg_q.clone()
    if lonely:
        seg_kv[1] = 7
    scale = 1.0 / float(np.sqrt(hd))
    every = _blocked_attention(*t, seg_q, seg_kv, scale, self_segments=False)
    ref = mha_reference(*t, seg_q, seg_kv, scale).numpy()
    assert_parity(f"fp32 kernel walk, S={s} hd={hd} {lengths} vs mha_reference",
                  every.numpy(), ref, ATOL)
    if lonely:
        assert bool(key_tiles_needed(seg_q, seg_kv, self_segments=False).all())
        np.testing.assert_allclose(every[1].numpy(), np.broadcast_to(v[1].mean(1, keepdims=True),
                                                                     v[1].shape), atol=ATOL)
        return
    needed = key_tiles_needed(seg_q, seg_q, self_segments=True)
    skipping = _blocked_attention(*t, seg_q, seg_q, scale, self_segments=True)
    assert torch.equal(skipping, every)
    assert bool(needed.all()) == (lengths == [512, 512])
    if hd == 128:
        with pltpu.force_tpu_interpret_mode():
            lib = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       segment_ids=SegmentIds(q=jnp.asarray(seg), kv=jnp.asarray(seg)),
                                       sm_scale=scale))
        assert_parity(f"fp32 kernel walk with skipping, S={s} hd={hd} vs pallas flash (interpret)",
                      skipping.numpy(), lib, ATOL)


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


def test_computed_tiles_is_counted_on_the_card_only():
    """The tile count comes from the kernel on the card, in bf16 and fp32
    alike: on CPU tensors, where the plain version computes every pair, the
    wrapper refuses the counter in either type instead of leaving it at
    zero."""
    q, k, v, seg = _case(5, 1, 2, 64, 64, [40])
    t = [torch.from_numpy(a) for a in (q, k, v, seg)]
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="computed_tiles"):
            flash_attention(*(x.to(dtype) for x in t[:3]), t[3], t[3], 0.125,
                            computed_tiles=torch.zeros(1, dtype=torch.int32))
    np.testing.assert_array_equal(flash_attention(t[0], t[1], t[2], t[3], t[3], 0.125).numpy(),
                                  mha_reference(t[0], t[1], t[2], t[3], t[3], 0.125).numpy())
