"""Flash attention forward with segment ids (counterpart of the JAX library
kernel ``jax.experimental.pallas.ops.tpu.flash_attention`` that the JAX
package's ``models/cxr_bert.py`` calls for ``use_flash_attention=True``).

:func:`flash_attention` launches the hand-written CUDA kernel
``csrc/flash_attention.cu`` for tensors on CUDA and takes the plain
version, :func:`mha_reference`, for tensors on the CPU.  Both take JAX's
layout, ``(B, nh, S, hd)``: a query of segment *s* attends only the keys
of segment *s*; a masked logit gets ``-0.7 * FLT_MAX`` added, not
``-inf``.  No backward: no path differentiates through the frozen text
tower yet.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)  # the JAX kernel's DEFAULT_MASK_VALUE
HEAD_DIMS = (64, 128)  # the head widths the kernel is built for

__all__ = ["MASK_VALUE", "flash_attention", "mha_reference"]


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  segment_ids_q: torch.Tensor, segment_ids_kv: torch.Tensor,
                  sm_scale: float = 1.0) -> torch.Tensor:
    """The plain version: the JAX library's ``_mha_reference`` with segment
    ids, computed in fp32 whatever the input type, returned in q's type.
    Materialises the (B, nh, S, S) logits."""
    logits = torch.einsum("bhqc,bhkc->bhqk", q.float(), k.float())
    if sm_scale != 1.0:
        logits = logits * sm_scale
    mask = (segment_ids_q[:, :, None] == segment_ids_kv[:, None, :])[:, None]
    logits = logits + torch.where(mask, 0.0, MASK_VALUE)
    m = logits.amax(dim=-1, keepdim=True)
    unnormalized = torch.exp(logits - m)
    weights = unnormalized / unnormalized.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkc->bhqc", weights, v.float()).to(q.dtype)


def _check_layout(name: str, t: torch.Tensor) -> None:
    """The kernel reads rows of hd elements with 16-byte loads: unit stride
    along hd, and 16-byte aligned batch, head and row offsets."""
    unit = 16 // t.element_size()
    if t.stride(3) != 1 or any(s % unit for s in t.stride()[:3]) or t.data_ptr() % 16:
        raise ValueError(f"flash_attention: {name} has strides {t.stride()}; the kernel needs "
                         f"a unit stride along hd and the others multiples of {unit}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    segment_ids_q: torch.Tensor, segment_ids_kv: torch.Tensor,
                    sm_scale: float = 1.0) -> torch.Tensor:
    """(B, nh, S, hd) q, k, v and (B, S) segment ids -> (B, nh, S, hd) in q's type.

    On CUDA the output is a ``(B, S, nh, hd)`` buffer seen as
    ``(B, nh, S, hd)``, so a caller that merges the heads back gets a view.
    The kernel takes bf16 or fp32, hd 64 or 128, and any S >= 1 (q and kv of
    one length)."""
    tensors = (q, k, v, segment_ids_q, segment_ids_kv)
    if all(t.device.type == "cpu" for t in tensors):
        return mha_reference(q, k, v, segment_ids_q, segment_ids_kv, sm_scale)
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError(f"flash_attention: operands on {sorted({str(t.device) for t in tensors})}")
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
    out = torch.empty((b, s, nh, hd), dtype=q.dtype, device=q.device).transpose(1, 2)
    if b == 0 or s == 0 or nh == 0:
        return out
    seg_q = segment_ids_q.to(torch.int32).contiguous()
    seg_kv = segment_ids_kv.to(torch.int32).contiguous()
    from incremental_multimodal_medical_learning_ii_torch.ops.cuda_build import load

    fn = load("flash_attention").flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    strides = (ctypes.c_longlong * 12)(*(st for t in (q, k, v, out) for st in t.stride()[:3]))
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), seg_q.data_ptr(),
            seg_kv.data_ptr(), ctypes.addressof(strides), b, nh, s, hd,
            int(q.dtype == torch.bfloat16), float(sm_scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {rc}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
