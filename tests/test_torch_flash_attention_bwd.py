"""Port ops/flash_attention.py's backward: the plain forward's log-sum-exp
against the library's residuals, the plain backward (which K3b is held to
on the card) against ``jax.vjp`` of the JAX library's Pallas kernel in TPU
interpret mode, the autograd function (gradcheck in float64, one order
only), and the text tower's gradients through ``use_flash_attention=True``
against ``jax.grad`` of the JAX package's.

The library kernel needs S divisible by its 128-row blocks, so the cases
against JAX use S = 128 and 256."""

import ctypes
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu.flash_attention import SegmentIds
from jax.experimental.pallas.ops.tpu.flash_attention import flash_attention as jax_flash
from jax.experimental.pallas.ops.tpu.flash_attention import mha_reference_no_custom_vjp

from incremental_multimodal_medical_learning_ii_tpu.models import cxr_bert as jbert
from incremental_multimodal_medical_learning_ii_torch.convert import params_from_jax
from incremental_multimodal_medical_learning_ii_torch.models import cxr_bert as tbert
from incremental_multimodal_medical_learning_ii_torch.ops import flash_attention as fa

from torch_port_helpers import assert_parity, one_torch_thread, to_numpy_tree  # noqa: F401

ATOL = 1e-5  # fp32: the plain backward against the library's, summation order only
# bf16: each side rounds its own bf16 forward output o (di = rowsum(o * do)),
# p and ds to bf16 before the products, and the gradients to bf16 (an ulp of
# the largest is 2^-8 of it): held to 2% of the largest gradient and a cosine
GRAD_BF16_REL = 2e-2
GRAD_BF16_COS = 0.9999
GRAD_ATOL = 5e-5  # the text tower: scaled by the largest gradient (tests/test_sp.py:199)

CASES = {  # name: (b, h, s, hd, lengths, lonely)
    "(1,2,128,64) padded": (1, 2, 128, 64, [100], False),
    "(2,2,256,128) padded": (2, 2, 256, 128, [256, 77], False),
    "(2,2,128,64) disjoint q/kv ids": (2, 2, 128, 64, [128, 90], True),
}


def _case(name, dtype):
    b, h, s, hd, lengths, lonely = CASES[name]
    rng = np.random.default_rng(b * s + hd)
    q, k, v, do = (rng.normal(size=(b, h, s, hd)).astype(np.float32) for _ in range(4))
    if dtype == "bfloat16":  # the same bf16 values on both sides
        q, k, v, do = (torch.from_numpy(a).bfloat16().float().numpy() for a in (q, k, v, do))
    seg_q = (np.arange(s)[None, :] < np.asarray(lengths)[:, None]).astype(np.int32)
    seg_kv = seg_q.copy()
    if lonely:  # row 1's queries share no key's segment: each averages every key
        seg_q[1] = 7
    return q, k, v, do, seg_q, seg_kv, 1.0 / float(np.sqrt(hd))


@pytest.fixture(scope="module")
def library():
    """``jax.vjp`` of the library kernel (interpret mode) for every case and
    type, each program compiled once."""
    out = {}
    for name in CASES:
        for dtype in ("float32", "bfloat16"):
            q, k, v, do, seg_q, seg_kv, scale = _case(name, dtype)
            jt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
            ids = SegmentIds(q=jnp.asarray(seg_q), kv=jnp.asarray(seg_kv))

            def f(q_, k_, v_, ids=ids, scale=scale):
                return jax_flash(q_, k_, v_, segment_ids=ids, sm_scale=scale)

            with pltpu.force_tpu_interpret_mode():
                o, vjp = jax.vjp(f, *(jnp.asarray(a, jt) for a in (q, k, v)))
                grads = vjp(jnp.asarray(do, jt))
            out[name, dtype] = (np.asarray(o, np.float32),
                                [np.asarray(g, np.float32) for g in grads])
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_plain_forward_lse_matches_the_library_residuals(name):
    """The plain forward's LSE against ``m + log(l)`` of the library's
    ``mha_reference_no_custom_vjp(save_residuals=True)``; o is
    :func:`mha_reference`'s bit for bit."""
    q, k, v, _, seg_q, seg_kv, scale = _case(name, "float32")
    out, l, m = mha_reference_no_custom_vjp(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        segment_ids=SegmentIds(q=jnp.asarray(seg_q), kv=jnp.asarray(seg_kv)), sm_scale=scale,
        save_residuals=True)
    t = [torch.from_numpy(a) for a in (q, k, v, seg_q, seg_kv)]
    o, lse = fa.mha_reference_with_lse(*t, scale)
    ref = np.asarray(m) + np.log(np.asarray(l))
    if CASES[name][-1]:  # a lonely row's log-sum-exp is the mask value itself
        assert np.all(lse.numpy()[1] == np.float32(fa.MASK_VALUE))
        np.testing.assert_array_equal(lse.numpy()[1], ref[1])
    err = float((np.abs(lse.numpy() - ref) / np.maximum(np.abs(ref), 1.0)).max())
    print(f"PARITY plain lse {name}: max of |port - jax| / max(|lse|, 1) = {err:.3e}")
    assert err <= ATOL
    assert_parity(f"plain forward o {name}", o.numpy(), np.asarray(out), ATOL)
    np.testing.assert_array_equal(o.numpy(), fa.mha_reference(*t, scale).numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CASES))
def test_plain_backward_matches_the_library_vjp(library, name, dtype):
    """``flash_attention_bwd_reference`` from the plain forward's o and lse
    against ``jax.vjp`` through the Pallas kernel (its dK/dV and dQ
    kernels), padded rows and queries that match no key included."""
    q, k, v, do, seg_q, seg_kv, scale = _case(name, dtype)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    tq, tk, tv, tdo = (torch.from_numpy(a).to(tdt) for a in (q, k, v, do))
    ids_q, ids_kv = torch.from_numpy(seg_q), torch.from_numpy(seg_kv)
    o, lse = fa.mha_reference_with_lse(tq, tk, tv, ids_q, ids_kv, scale)
    grads = fa.flash_attention_bwd_reference(tq, tk, tv, o, lse, tdo, ids_q, ids_kv, scale)
    assert all(g.dtype == tdt for g in grads)
    ref_o, refs = library[name, dtype]
    for gname, ours, ref in zip(("dq", "dk", "dv"), grads, refs):
        ours = ours.float().numpy()
        if dtype == "float32":
            assert_parity(f"plain backward {gname} {name}", ours, ref, ATOL)
            continue
        rel = float(np.abs(ours - ref).max() / np.abs(ref).max())
        cos = float((ours * ref).sum() / (np.linalg.norm(ours) * np.linalg.norm(ref)))
        print(f"PARITY plain backward {gname} {name} bf16: max |port - jax| / largest = "
              f"{rel:.3e} (bar {GRAD_BF16_REL:g}), cos {cos:.7f} (bar {GRAD_BF16_COS})")
        assert rel <= GRAD_BF16_REL and cos > GRAD_BF16_COS, (gname, rel, cos)
    # the wrapper on CPU tensors is exactly the plain backward
    same = fa.flash_attention_bwd(tq, tk, tv, o, lse, tdo, ids_q, ids_kv, scale)
    for a, b in zip(same, grads):
        assert torch.equal(a, b)


def test_function_gradcheck_and_one_order_only():
    """The autograd function on the CPU, in float64, at a tiny shape with a
    padded row: its backward is the plain one and passes ``gradcheck``;
    differentiating its backward raises, as the library's custom VJP does
    (``NotImplementedError("Higher-order AD not supported")``)."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 2, 9, 16))).requires_grad_(True)
               for _ in range(3))
    seg = torch.tensor([[1] * 9, [1] * 5 + [0] * 4], dtype=torch.int32)
    assert torch.autograd.gradcheck(lambda a, b, c: fa.flash_attention(a, b, c, seg, seg, 0.3),
                                    (q, k, v))
    out = fa.flash_attention(q, k, v, seg, seg, 0.3)
    assert out.grad_fn is not None and out.dtype == torch.float64
    (dq,) = torch.autograd.grad((out * out).sum(), q, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        dq.sum().backward()
    with torch.no_grad():  # no grad: the plain forward, no graph
        plain = fa.flash_attention(q, k, v, seg, seg, 0.3)
    assert plain.grad_fn is None and torch.equal(plain, out.detach())


def _c_argtypes(src: str, name: str) -> list:
    """The ctypes type of each parameter of the C launcher ``name``: a
    pointer is ``c_void_p``, an int ``c_int``, a float ``c_float``."""
    m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
    assert m, name
    out = []
    for param in m.group(1).split(","):
        param = " ".join(param.split())
        if "*" in param:
            out.append(ctypes.c_void_p)
        elif param.startswith("int "):
            out.append(ctypes.c_int)
        else:
            assert param.startswith("float "), param
            out.append(ctypes.c_float)
    return out


def test_backward_launcher_signature_matches_the_bound_argtypes():
    """The backward wrapper binds its launcher's ``argtypes`` once (ctypes
    checks nothing against the C side): they are the C launcher's, type by
    type, the skip flag and the two-pass tile counter included; the
    forward's launcher takes the ``lse`` pointer."""
    from incremental_multimodal_medical_learning_ii_torch.ops import cuda_build

    src = (cuda_build.CSRC_DIR / cuda_build.SOURCES["flash_attention_bwd"]).read_text()
    assert _c_argtypes(src, "flash_attention_bwd_launch") == fa._BWD_ARGTYPES
    assert fa._BWD_ARGTYPES.count(ctypes.c_void_p) == 15
    m = re.search(r'extern "C" int flash_attention_bwd_launch\(([^)]*)\)', src)
    assert "int self_segments" in m.group(1) and "void* tiles" in m.group(1)
    fwd = (cuda_build.CSRC_DIR / cuda_build.SOURCES["flash_attention"]).read_text()
    m = re.search(r'extern "C" int flash_attention_launch\(([^)]*)\)', fwd)
    assert "void* lse" in m.group(1)
    assert _c_argtypes(fwd, "flash_attention_launch") == fa._ARGTYPES


def test_backward_refuses_foreign_devices():
    """Meta tensors are refused, not run on the CPU; CPU tensors count no
    launch."""
    q = torch.zeros(1, 2, 8, 64, device="meta")
    lse = torch.zeros(1, 2, 8, device="meta")
    seg = torch.ones(1, 8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="meta"):
        fa.flash_attention_bwd(q, q, q, q, lse, q, seg, seg, 0.125)
    before = fa.flash_attention_bwd.launches
    x, s = torch.ones(1, 2, 8, 64), torch.ones(1, 8, dtype=torch.int32)
    o, lse = fa.mha_reference_with_lse(x, x, x, s, s, 0.125)
    grads = fa.flash_attention_bwd(x, x, x, o, lse, x, s, s, 0.125)
    assert all(g.shape == x.shape for g in grads) and fa.flash_attention_bwd.launches == before


TOWER_DIMS = dict(vocab_size=99, hidden_size=128, num_layers=2, num_heads=2,
                  intermediate_size=256, max_position_embeddings=128, projection_size=32)


@pytest.fixture(scope="module")
def tower():
    """2 layers, hidden 128, 2 heads (hd 64), batch 3 at S = 128 with two
    padded rows; the JAX gradient of sum(w * projection) through the
    flash path in interpret mode, compiled once."""
    jdims = jbert.tiny_bert_dims(**TOWER_DIMS)
    params = jax.jit(jbert.init_cxr_bert, static_argnums=1)(jax.random.PRNGKey(7), jdims)
    rng = np.random.default_rng(8)
    ids = rng.integers(5, jdims.vocab_size, size=(3, 128)).astype(np.int32)
    mask = np.ones((3, 128), np.int32)
    mask[1, 70:] = 0
    mask[2, 20:] = 0
    w = rng.normal(size=(3, jdims.projection_size)).astype(np.float32)

    def loss(p):
        out = jbert.get_projected_text_embeddings(p, jnp.asarray(ids), jnp.asarray(mask), jdims,
                                                  use_flash_attention=True)
        return jnp.sum(out * jnp.asarray(w))

    with pltpu.force_tpu_interpret_mode():
        value, grads = jax.jit(jax.value_and_grad(loss))(params)
    tree = to_numpy_tree(params)
    return jdims, tree, ids, mask, w, float(value), to_numpy_tree(grads)


def test_text_tower_flash_gradients_match_jax(tower):
    """The port's gradient of every parameter through
    ``get_projected_text_embeddings(use_flash_attention=True)`` (weights
    carried by ``params_from_jax``) against ``jax.grad`` of the JAX
    package's flash path, scaled by the largest gradient; on the CPU the
    attention's backward is the plain one."""
    jdims, tree, ids, mask, w, value, grads = tower
    dims = tbert.BertDims(**dataclasses.asdict(jdims))
    model = params_from_jax(tree, dims).requires_grad_(True)
    out = tbert.get_projected_text_embeddings(model, torch.from_numpy(ids),
                                              torch.from_numpy(mask), use_flash_attention=True)
    loss = (out * torch.from_numpy(w)).sum()
    assert abs(float(loss) - value) <= 1e-4 * max(1.0, abs(value))
    loss.backward()
    ref = {k: v.numpy() for k, v in params_from_jax(grads, dims).state_dict().items()}
    # a parameter off the projection's path (the MLM head) gets no gradient: zeros in JAX
    got = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
           for k, p in model.named_parameters()}
    assert sorted(got) == sorted(ref)
    scale = max(float(np.abs(v).max()) for v in ref.values())
    err = max(float(np.abs(got[k] - ref[k]).max()) for k in ref) / scale
    print(f"PARITY text tower flash gradients: max |port - jax| / largest = {err:.3e} "
          f"(bar {GRAD_ATOL:g})")
    for k in ref:
        np.testing.assert_allclose(got[k] / scale, ref[k] / scale, rtol=0, atol=GRAD_ATOL,
                                   err_msg=k)


def _ragged(seed, b, h, s, hd, lengths):
    """fp32 q, k, v, do and (B, S) key-padding ids from ``lengths``."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(b, h, s, hd)).astype(np.float32))
                   for _ in range(4))
    seg = torch.from_numpy((np.arange(s)[None, :] < np.asarray(lengths)[:, None]).astype(np.int32))
    return q, k, v, do, seg, 1.0 / float(np.sqrt(hd))


def _blocked_backward(q, k, v, o, lse, do, seg_q, seg_kv, scale, self_segments, shares=False):
    """K3b's tile walk in fp32: the dK/dV pass takes a 64-key tile at a time
    and walks the 64-query blocks in order, the dQ pass a query block at a
    time over the key tiles; a pair that ``key_tiles_needed`` rules out
    (one id array only) is not computed.  p and ds of a pair as the plain
    backward forms them.  With ``shares`` (the fp32 kernels) dQ is formed
    instead in the dK/dV pass: each CTA of ``shares`` key tiles adds its
    tiles' ds k into its own share of every query block one of its tiles
    needs (a tile it skips adds zeros), and the shares are summed in CTA
    order.  Returns the gradients and the pairs each pass computed."""
    b, _, s, _ = q.shape
    needed = fa.key_tiles_needed(seg_q, seg_kv, self_segments)
    n = needed.shape[1]
    di = (o * do).sum(-1)
    dq, dk, dv = (torch.zeros_like(q) for _ in range(3))

    def pair(bi, i, j):
        qs, ks = slice(i * fa.BLOCK, (i + 1) * fa.BLOCK), slice(j * fa.BLOCK, (j + 1) * fa.BLOCK)
        logits = q[bi, :, qs] @ k[bi, :, ks].transpose(-1, -2) * scale
        same = seg_q[bi, qs, None] == seg_kv[bi, None, ks]
        logits = logits + torch.where(same, 0.0, fa.MASK_VALUE)
        rl = lse[bi, :, qs, None]
        p = torch.exp(logits - rl)
        p = torch.where(rl < 0.5 * fa.MASK_VALUE, p * (1.0 / s), p)
        dp = do[bi, :, qs] @ v[bi, :, ks].transpose(-1, -2)
        return p, (dp - di[bi, :, qs, None]) * p * scale, qs, ks

    pairs = {"dkv": 0, "dq": 0}
    for bi in range(b):
        for j in range(n):  # dK/dV: a key tile over the query blocks
            for i in range(n):
                if needed[bi, i, j]:
                    pairs["dkv"] += 1
                    p, ds, qs, ks = pair(bi, i, j)
                    dv[bi, :, ks] += p.transpose(-1, -2) @ do[bi, :, qs]
                    dk[bi, :, ks] += ds.transpose(-1, -2) @ q[bi, :, qs]
        if shares:  # dQ: the CTAs' shares, summed in CTA order
            for i in range(n):
                for c0 in range(0, n, shares):
                    tiles = range(c0, min(c0 + shares, n))
                    if not any(needed[bi, i, j] for j in tiles):
                        continue
                    share = 0
                    for j in tiles:
                        _, ds, qs, ks = pair(bi, i, j)
                        if needed[bi, i, j]:
                            pairs["dq"] += 1
                            share = share + ds @ k[bi, :, ks]
                    dq[bi, :, qs] += share
            continue
        for i in range(n):  # dQ: a query block over the key tiles
            for j in range(n):
                if needed[bi, i, j]:
                    pairs["dq"] += 1
                    _, ds, qs, ks = pair(bi, i, j)
                    dq[bi, :, qs] += ds @ k[bi, :, ks]
    return (dq, dk, dv), pairs


@pytest.mark.parametrize("s,hd,lengths", [
    (512, 64, [1, 63, 64, 65, 300, 512]),  # every edge of a 64-row block
    (200, 64, [200, 1, 123]),              # a ragged last tile
    (512, 64, [512, 512]),                 # nothing to skip
    (256, 128, [256, 200, 130, 17]),       # hd 128
])
@pytest.mark.parametrize("shares", [0, 2], ids=["dq pass", "dq shares"])
def test_backward_tile_skipping_is_exact(s, hd, lengths, shares):
    """K3b's two passes skipping the pairs key_tiles_needed rules out (one
    id array: BERT's key-padding masks) change no bit of a blocked walk's
    gradients, which agree with the plain backward (held against the
    Pallas kernel's VJP above); each pass computes the predicate's pairs.
    Both ways of forming dQ: the bf16 kernels' dQ pass, and the fp32
    kernels' shares of CTAs of two key tiles summed in order."""
    q, k, v, do, seg, scale = _ragged(s + hd, len(lengths), 2, s, hd, lengths)
    o, lse = fa.mha_reference_with_lse(q, k, v, seg, seg, scale)
    skipping, pairs = _blocked_backward(q, k, v, o, lse, do, seg, seg, scale, True, shares)
    every, all_pairs = _blocked_backward(q, k, v, o, lse, do, seg, seg, scale, False, shares)
    needed = fa.key_tiles_needed(seg, seg, self_segments=True)
    assert pairs == {"dkv": int(needed.sum()), "dq": int(needed.sum())}
    assert all_pairs == {"dkv": needed.numel(), "dq": needed.numel()}
    assert bool(needed.all()) == (lengths == [512, 512])
    ref = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, seg, seg, scale)
    for name, a, b, r in zip(("dq", "dk", "dv"), skipping, every, ref):
        assert torch.equal(a, b), name
        rel = float((a - r).abs().max() / r.abs().max())
        print(f"PARITY blocked backward ({'shares' if shares else 'dq pass'}) {name} S={s} "
              f"hd={hd} {lengths} vs the plain backward: "
              f"max |walk - plain| / largest = {rel:.3e} (bar {ATOL:g})")
        assert rel <= ATOL, (name, rel)


def test_backward_two_id_arrays_skip_nothing():
    """With two id arrays (queries whose segment no key shares: their
    softmax is uniform) the walk computes every pair and still agrees with
    the plain backward; the predicate keeps every pair."""
    q, k, v, do, seg_q, scale = _ragged(5, 2, 2, 200, 64, [200, 150])
    seg_kv = seg_q.clone()
    seg_kv[1] = 7  # row 1's queries share no key's segment
    o, lse = fa.mha_reference_with_lse(q, k, v, seg_q, seg_kv, scale)
    assert bool((lse[1] < 0.5 * fa.MASK_VALUE).all())
    grads, pairs = _blocked_backward(q, k, v, o, lse, do, seg_q, seg_kv, scale, False)
    assert bool(fa.key_tiles_needed(seg_q, seg_kv, self_segments=False).all())
    assert pairs == {"dkv": 2 * 4 * 4, "dq": 2 * 4 * 4}
    ref = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, seg_q, seg_kv, scale)
    for name, a, r in zip(("dq", "dk", "dv"), grads, ref):
        rel = float((a - r).abs().max() / r.abs().max())
        print(f"PARITY blocked backward {name}, two id arrays: max |walk - plain| / largest = "
              f"{rel:.3e} (bar {ATOL:g})")
        assert rel <= ATOL, (name, rel)


def test_backward_computed_tiles_is_for_the_kernel_only():
    """The pair counts come from the kernel on the card: the wrapper
    refuses a counter of the wrong type or size, and any counter beside CPU
    operands (the plain backward computes every pair), instead of leaving it
    at zero."""
    q, k, v, do, seg, scale = _ragged(9, 1, 2, 64, 64, [40])
    o, lse = fa.mha_reference_with_lse(q, k, v, seg, seg, scale)
    with pytest.raises(ValueError, match="two-element int32"):
        fa.flash_attention_bwd(q, k, v, o, lse, do, seg, seg, scale,
                               computed_tiles=torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError, match="two-element int32"):
        fa.flash_attention_bwd(q, k, v, o, lse, do, seg, seg, scale,
                               computed_tiles=torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="on the card"):
        fa.flash_attention_bwd(q, k, v, o, lse, do, seg, seg, scale,
                               computed_tiles=torch.zeros(2, dtype=torch.int32))
    for a, b in zip(fa.flash_attention_bwd(q, k, v, o, lse, do, seg, seg, scale),
                    fa.flash_attention_bwd_reference(q, k, v, o, lse, do, seg, seg, scale)):
        assert torch.equal(a, b)


def test_backward_scratch_and_tma_strides():
    """The scratch the wrapper allocates holds the di rows (rounded up to
    even, so the ranges that follow are 8-byte aligned) and 4 ints a 64-row
    block of every batch row; an expanded ``do`` (stride 0 along a
    dimension longer than one, which TMA cannot step) is copied."""
    assert fa._bwd_scratch_elems(2, 12, 512, 64, torch.bfloat16) == 2 * 12 * 512 + 4 * 2 * 8
    assert fa._bwd_scratch_elems(1, 1, 77, 64, torch.bfloat16) == 78 + 4 * 2
    # fp32: + the shares of dQ, (B, nh, CTAs of 128 keys (64 at hd 128), S, hd), 16-byte aligned
    assert fa._bwd_scratch_elems(1, 1, 77, 64, torch.float32) == 88 + 77 * 64
    assert fa._bwd_scratch_elems(2, 12, 512, 128, torch.float32) == (
        2 * 12 * 512 + 4 * 2 * 8 + 2 * 12 * 8 * 512 * 128)
    x = torch.zeros(2, 1, 8, 64)
    assert fa._tma_steps(x) and fa._tma_steps(torch.zeros(2, 3, 8, 64))
    assert not fa._tma_steps(x.expand(2, 3, 8, 64))
    assert fa._tma_steps(torch.zeros(1, 3, 8, 64)[:, :1])
