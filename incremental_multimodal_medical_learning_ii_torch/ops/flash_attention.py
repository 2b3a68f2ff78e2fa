"""Flash attention with segment ids, forward and backward (counterpart of
the JAX library kernel ``jax.experimental.pallas.ops.tpu.flash_attention``
that the JAX package's ``models/cxr_bert.py`` calls for
``use_flash_attention=True``, with its custom VJP).

:func:`flash_attention` launches the hand-written CUDA kernel
``csrc/flash_attention.cu`` for tensors on CUDA and takes the plain
version, :func:`mha_reference`, for tensors on the CPU.  Both take JAX's
layout, ``(B, nh, S, hd)``: a query of segment *s* attends only the keys
of segment *s*; a masked logit gets ``-0.7 * FLT_MAX`` added, not
``-inf``.

When q and kv carry one segment array (the same tensor, or one with the
same pointer, shape and strides), the kernel skips the key tiles that no
query of a 64-row block can see, exactly, in bf16 and fp32 alike
(:func:`key_tiles_needed` is its predicate).  A clone of the ids as
``segment_ids_kv`` turns the skipping off.  With ``computed_tiles`` the
kernel also counts, on the card, the (query block, key tile) pairs it
computed.

Gradients: when grad mode is on and q, k or v requires grad, the call goes
through an autograd function whose forward also keeps each row's
log-sum-exp (the kernel's ``lse`` output) and whose backward is
:func:`flash_attention_bwd`, the CUDA kernel ``csrc/flash_attention_bwd.cu``
(the library's dK/dV and dQ kernels) on the card, which skips the same
pairs as the forward, in both types and both passes.  On the CPU the
same function runs the plain versions, :func:`mha_reference_with_lse` and
:func:`flash_attention_bwd_reference`.  The backward differentiates once:
a second order raises, as the library's ``NotImplementedError``.  Without
grad the path is the forward alone, as before.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from incremental_multimodal_medical_learning_ii_torch.ops.cuda_build import current_stream, launcher

MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)  # the JAX kernel's DEFAULT_MASK_VALUE
HEAD_DIMS = (64, 128)  # the head widths the kernel is built for
BLOCK = 64  # the kernels' query block (a warpgroup in bf16, half a CTA in fp32) and key tile
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int,
                                                          ctypes.c_void_p, ctypes.c_void_p,
                                                          ctypes.c_void_p]
_Strides = ctypes.c_longlong * 12
_BWD_ARGTYPES = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int,
                                                              ctypes.c_void_p, ctypes.c_void_p]
_BwdStrides = ctypes.c_longlong * 24

__all__ = ["MASK_VALUE", "flash_attention", "flash_attention_bwd", "flash_attention_bwd_reference",
           "key_tiles_needed", "mha_reference", "mha_reference_with_lse"]


def _acc_type(t: torch.Tensor) -> torch.dtype:
    """The plain versions' arithmetic type: fp64 for fp64 inputs (a
    gradient check), fp32 for everything else."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _masked_logits(q, k, segment_ids_q, segment_ids_kv, sm_scale):
    """(B, nh, S, S) logits as the library builds them: the dot product,
    scaled, then the mask value added where the segments differ."""
    acc = _acc_type(q)
    logits = torch.einsum("bhqc,bhkc->bhqk", q.to(acc), k.to(acc))
    if sm_scale != 1.0:
        logits = logits * sm_scale
    mask = (segment_ids_q[:, :, None] == segment_ids_kv[:, None, :])[:, None]
    return logits + torch.where(mask, 0.0, MASK_VALUE)


def mha_reference_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           segment_ids_q: torch.Tensor, segment_ids_kv: torch.Tensor,
                           sm_scale: float = 1.0):
    """The plain forward that also returns each row's log-sum-exp:
    ``(o, lse)``, o in q's type and lse ``(B, nh, S)`` = m + log(l) in the
    arithmetic type (the library's ``l`` and ``m`` residuals in one number).
    Materialises the (B, nh, S, S) logits."""
    logits = _masked_logits(q, k, segment_ids_q, segment_ids_kv, sm_scale)
    m = logits.amax(dim=-1, keepdim=True)
    unnormalized = torch.exp(logits - m)
    l = unnormalized.sum(dim=-1, keepdim=True)
    weights = unnormalized / l
    out = torch.einsum("bhqk,bhkc->bhqc", weights, v.to(logits.dtype)).to(q.dtype)
    return out, (m + torch.log(l))[..., 0]


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  segment_ids_q: torch.Tensor, segment_ids_kv: torch.Tensor,
                  sm_scale: float = 1.0) -> torch.Tensor:
    """The plain version: the JAX library's ``_mha_reference`` with segment
    ids, computed in fp32 whatever the input type (fp64 for fp64), returned
    in q's type.  Materialises the (B, nh, S, S) logits."""
    return mha_reference_with_lse(q, k, v, segment_ids_q, segment_ids_kv, sm_scale)[0]


def flash_attention_bwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                                  segment_ids_q: torch.Tensor, segment_ids_kv: torch.Tensor,
                                  sm_scale: float = 1.0):
    """The plain backward: ``(dq, dk, dv)`` by the library's formulas
    (``_flash_attention_bwd`` and its dK/dV and dQ kernels), written out
    step by step from the forward's ``lse``, not autograd of
    :func:`mha_reference`.  fp32 arithmetic (fp64 for fp64); p is rounded
    to do's type before dv's product and ds to q's type before dk's and
    dq's, as the library rounds; results in the inputs' types.

    A row whose segment no key shares has every logit equal to the mask
    value in fp32 (so is its lse: log(l) is below its ulp), and its softmax
    is uniform over the S keys: such a row (lse below half the mask value)
    takes p = 1/S, as the library's separate m and l give it."""
    acc = _acc_type(q)
    s = q.shape[2]
    di = (o.to(acc) * do.to(acc)).sum(-1)[..., None]  # (B, nh, S, 1)
    lse = lse.to(acc)[..., None]
    p = torch.exp(_masked_logits(q, k, segment_ids_q, segment_ids_kv, sm_scale) - lse)
    p = torch.where(lse < 0.5 * MASK_VALUE, p * (1.0 / s), p)
    dv = torch.einsum("bhqk,bhqc->bhkc", p.to(do.dtype).to(acc), do.to(acc))
    dp = torch.einsum("bhqc,bhkc->bhqk", do.to(acc), v.to(acc))
    ds = (dp - di) * p
    if sm_scale != 1.0:
        ds = ds * sm_scale
    ds = ds.to(q.dtype).to(acc)
    dk = torch.einsum("bhqk,bhqc->bhkc", ds, q.to(acc))
    dq = torch.einsum("bhqk,bhkc->bhqc", ds, k.to(acc))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _block_ranges(seg: torch.Tensor):
    """Per 64-row block of (B, S) ids: the min and max id (B, n) each."""
    b, s = seg.shape
    n = -(-s // BLOCK)
    big = torch.iinfo(torch.int64).max
    lo = torch.full((b, n * BLOCK), big, dtype=torch.int64, device=seg.device)
    hi = torch.full((b, n * BLOCK), -big, dtype=torch.int64, device=seg.device)
    lo[:, :s] = seg
    hi[:, :s] = seg
    return lo.reshape(b, n, BLOCK).amin(-1), hi.reshape(b, n, BLOCK).amax(-1)


def key_tiles_needed(segment_ids_q: torch.Tensor, segment_ids_kv: torch.Tensor,
                     self_segments: bool) -> torch.Tensor:
    """The kernels' skip predicate (K3 in both types, and both passes of
    K3b): (B, n, n) bool, n = ceil(S / 64), True where key tile j is
    computed for query block i.  With ``self_segments`` a tile is skipped
    when the [min, max] ranges of the two blocks' segment ids (positions
    below S) are disjoint, so no query of the block shares a segment with
    a key of the tile; otherwise every tile is computed."""
    b, s = segment_ids_q.shape
    n = -(-s // BLOCK)
    if not self_segments:
        return torch.ones((b, n, n), dtype=torch.bool, device=segment_ids_q.device)
    qlo, qhi = _block_ranges(segment_ids_q)
    klo, khi = _block_ranges(segment_ids_kv)
    return (qlo[:, :, None] <= khi[:, None, :]) & (klo[:, None, :] <= qhi[:, :, None])


def _same_array(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a is b or (a.data_ptr() == b.data_ptr() and a.dtype == b.dtype
                      and a.shape == b.shape and a.stride() == b.stride())


def _layout_ok(t: torch.Tensor) -> bool:
    """The kernels read rows of hd elements with 16-byte loads: unit stride
    along hd, and 16-byte aligned batch, head and row offsets."""
    unit = 16 // t.element_size()
    return t.stride(3) == 1 and not any(s % unit for s in t.stride()[:3]) and t.data_ptr() % 16 == 0


def _check_layout(name: str, t: torch.Tensor) -> None:
    if not _layout_ok(t):
        unit = 16 // t.element_size()
        raise ValueError(f"flash_attention: {name} has strides {t.stride()}; the kernel needs "
                         f"a unit stride along hd and the others multiples of {unit}")


def _check_operands(q, k, v, segment_ids_q, segment_ids_kv) -> tuple:
    """(B, nh, S, hd) after the checks both kernels share."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"expected equal (B, nh, S, hd) q, k, v; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, nh, s, hd = q.shape
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"expected bfloat16 or float32 q, k, v of one type; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head width {hd} not in the kernel's {HEAD_DIMS}")
    if segment_ids_q.shape != (b, s) or segment_ids_kv.shape != (b, s):
        raise ValueError(f"expected ({b}, {s}) segment ids, got {tuple(segment_ids_q.shape)} "
                         f"and {tuple(segment_ids_kv.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_layout(name, t)
    return b, nh, s, hd


def _check_devices(name: str, tensors) -> bool:
    """True when every operand lies on the CPU (the plain versions); raises
    unless they all lie on one CUDA card."""
    if all(t.device.type == "cpu" for t in tensors):
        return True
    if tensors[0].device.type != "cuda" or any(t.device != tensors[0].device for t in tensors):
        raise ValueError(f"{name}: operands on {sorted({str(t.device) for t in tensors})}")
    return False


def _forward_kernel(q, k, v, segment_ids_q, segment_ids_kv, sm_scale, computed_tiles,
                    with_lse: bool):
    """K3 on the card: ``(out, lse)``, lse a (B, nh, S) fp32 tensor when
    ``with_lse`` (else None; the output is the same either way)."""
    b, nh, s, hd = _check_operands(q, k, v, segment_ids_q, segment_ids_kv)
    out = torch.empty((b, s, nh, hd), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty((b, nh, s), dtype=torch.float32, device=q.device) if with_lse else None
    if b == 0 or s == 0 or nh == 0:
        return out, lse
    self_segments = _same_array(segment_ids_q, segment_ids_kv)
    seg_q = segment_ids_q.to(torch.int32).contiguous()
    seg_kv = seg_q if self_segments else segment_ids_kv.to(torch.int32).contiguous()
    fn = launcher("flash_attention", "flash_attention_launch", _ARGTYPES)
    strides = _Strides(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), seg_q.data_ptr(),
            seg_kv.data_ptr(), ctypes.addressof(strides), b, nh, s, hd,
            int(q.dtype == torch.bfloat16), float(sm_scale), int(self_segments),
            computed_tiles.data_ptr() if computed_tiles is not None else None,
            lse.data_ptr() if lse is not None else None, current_stream(q))
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {rc}")
    flash_attention.launches += 1
    return out, lse


class _FlashAttention(torch.autograd.Function):
    """The forward keeps q, k, v, the output, its log-sum-exp and the ids;
    the backward is :func:`flash_attention_bwd` (K3b on the card, the plain
    backward on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids_q, segment_ids_kv, sm_scale, computed_tiles):
        if q.device.type == "cpu":
            out, lse = mha_reference_with_lse(q, k, v, segment_ids_q, segment_ids_kv, sm_scale)
        else:
            out, lse = _forward_kernel(q, k, v, segment_ids_q, segment_ids_kv, sm_scale,
                                       computed_tiles, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse, segment_ids_q, segment_ids_kv)
        ctx.sm_scale = sm_scale
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, out, lse, segment_ids_q, segment_ids_kv = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, segment_ids_q, segment_ids_kv,
                                         ctx.sm_scale)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    segment_ids_q: torch.Tensor, segment_ids_kv: torch.Tensor,
                    sm_scale: float = 1.0, *,
                    computed_tiles: torch.Tensor | None = None) -> torch.Tensor:
    """(B, nh, S, hd) q, k, v and (B, S) segment ids -> (B, nh, S, hd) in q's type.

    On CUDA the output is a ``(B, S, nh, hd)`` buffer seen as
    ``(B, nh, S, hd)``, so a caller that merges the heads back gets a view.
    The kernel takes bf16 or fp32, hd 64 or 128, and any S >= 1 (q and kv of
    one length).  ``computed_tiles``, on CUDA only (bf16 or fp32), is a
    one-element int32 tensor on q's card to which the kernel adds the
    number of (64-query block, 64-key tile) pairs it computed, summed over
    heads; on the CPU, where the plain version computes every pair, it is
    refused.
    Under grad mode, when q, k or v requires grad, the result carries the
    backward (module docstring)."""
    tensors = (q, k, v, segment_ids_q, segment_ids_kv)
    if computed_tiles is not None and not (
            q.device.type == "cuda" and computed_tiles.device == q.device
            and computed_tiles.dtype == torch.int32 and computed_tiles.numel() == 1):
        raise ValueError("computed_tiles: the kernel on CUDA counts into a one-element "
                         "int32 tensor on q's card")
    on_cpu = _check_devices("flash_attention", tensors)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, segment_ids_q, segment_ids_kv, sm_scale,
                                     computed_tiles)
    if on_cpu:
        return mha_reference(q, k, v, segment_ids_q, segment_ids_kv, sm_scale)
    return _forward_kernel(q, k, v, segment_ids_q, segment_ids_kv, sm_scale, computed_tiles,
                           with_lse=False)[0]


flash_attention.launches = 0


def _bwd_scratch_elems(b: int, nh: int, s: int, hd: int, dtype: torch.dtype) -> int:
    """fp32 elements of K3b's scratch: the prologue's di rows (rounded up to
    even) and 4 ints for each 64-row block of every batch row (the [min,
    max] segment ids of both id arrays), rounded up to a multiple of 4; in
    fp32 then each dK/dV CTA's share of dQ (a CTA holds 128 keys at hd 64,
    64 at hd 128), which the third kernel sums."""
    rows = b * nh * s
    n = rows + (rows & 1) + 4 * b * (-(-s // BLOCK))
    if dtype != torch.float32:
        return n
    keys = 2 * BLOCK if hd == 64 else BLOCK
    return -(-n // 4) * 4 + b * nh * (-(-s // keys)) * s * hd


def _tma_steps(t: torch.Tensor) -> bool:
    """TMA steps every dimension longer than one by a positive stride (an
    expanded dimension's stride 0 it cannot)."""
    return all(st > 0 or n == 1 for n, st in zip(t.shape[:3], t.stride()[:3]))


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                        lse: torch.Tensor, do: torch.Tensor, segment_ids_q: torch.Tensor,
                        segment_ids_kv: torch.Tensor, sm_scale: float = 1.0, *,
                        computed_tiles: torch.Tensor | None = None):
    """The gradients ``(dq, dk, dv)`` of :func:`flash_attention` from its
    output ``o``, its log-sum-exp ``lse`` ((B, nh, S) fp32, the forward's)
    and the output's gradient ``do``.

    On CUDA this launches K3b (``csrc/flash_attention_bwd.cu``: the
    prologue, the dK/dV kernel, and the dQ kernel in bf16 or the sum of the
    dK/dV CTAs' shares of dQ in fp32) and returns ``(B, S, nh, hd)``
    buffers seen as ``(B, nh, S, hd)``, the layout of the forward's
    output, which a fused QKV projection's split views take back; ``do``
    may have any strides (it is copied when the kernel cannot read it in
    place).  When the two id arrays are one (:func:`_same_array`, as
    ``models/cxr_bert.py`` passes its mask twice), both passes skip the
    (64-query block, 64-key tile) pairs :func:`key_tiles_needed` rules
    out, exactly; a copy of the ids as ``segment_ids_kv`` turns skipping
    off.  ``computed_tiles``, on CUDA only, is a two-element int32 tensor on
    q's card to which the dK/dV pass (element 0) and the dQ products
    (element 1: the dQ pass in bf16, the dK/dV pass in fp32) add the pairs
    they computed, summed over heads.  For tensors on the CPU it takes
    :func:`flash_attention_bwd_reference`."""
    tensors = (q, k, v, o, lse, do, segment_ids_q, segment_ids_kv)
    on_cpu = _check_devices("flash_attention_bwd", tensors)
    if computed_tiles is not None:
        if computed_tiles.dtype != torch.int32 or computed_tiles.numel() != 2:
            raise ValueError("computed_tiles: a two-element int32 tensor (the dK/dV pass's "
                             f"count, the dQ pass's); got {computed_tiles.dtype} "
                             f"{tuple(computed_tiles.shape)}")
        if on_cpu or computed_tiles.device != q.device:
            raise ValueError("computed_tiles: the kernel counts on the card, into a tensor on "
                             f"q's card ({q.device}); got {computed_tiles.device}")
    if on_cpu:
        return flash_attention_bwd_reference(q, k, v, o, lse, do, segment_ids_q, segment_ids_kv,
                                             sm_scale)
    b, nh, s, hd = _check_operands(q, k, v, segment_ids_q, segment_ids_kv)
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError(f"expected o and do like q {tuple(q.shape)} {q.dtype}; got "
                         f"{tuple(o.shape)} {o.dtype} and {tuple(do.shape)} {do.dtype}")
    if lse.shape != (b, nh, s) or lse.dtype != torch.float32:
        raise ValueError(f"expected a ({b}, {nh}, {s}) float32 lse; got {tuple(lse.shape)} "
                         f"{lse.dtype}")
    _check_layout("o", o)
    if not (_layout_ok(do) and _tma_steps(do)):
        do = do.clone(memory_format=torch.contiguous_format)
    grads = tuple(torch.empty((b, s, nh, hd), dtype=q.dtype, device=q.device).transpose(1, 2)
                  for _ in range(3))
    if b == 0 or s == 0 or nh == 0:
        return grads
    lse = lse.contiguous()
    scratch = torch.empty(_bwd_scratch_elems(b, nh, s, hd, q.dtype), dtype=torch.float32,
                          device=q.device)
    self_segments = _same_array(segment_ids_q, segment_ids_kv)
    seg_q = segment_ids_q.to(torch.int32).contiguous()
    seg_kv = seg_q if self_segments else segment_ids_kv.to(torch.int32).contiguous()
    fn = launcher("flash_attention_bwd", "flash_attention_bwd_launch", _BWD_ARGTYPES)
    strides = _BwdStrides(*(st for t in (q, k, v, o, do, *grads) for st in t.stride()[:3]))
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
            scratch.data_ptr(), *(g.data_ptr() for g in grads), seg_q.data_ptr(),
            seg_kv.data_ptr(), ctypes.addressof(strides), b, nh, s, hd,
            int(q.dtype == torch.bfloat16), float(sm_scale), int(self_segments),
            computed_tiles.data_ptr() if computed_tiles is not None else None, current_stream(q))
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA error {rc}")
    flash_attention_bwd.launches += 1
    return grads


flash_attention_bwd.launches = 0
