"""One pass over a convolution's output: frozen batch norm, an optional
residual and an optional ReLU (the port's own kernel; the JAX package
leaves this fusion to XLA).

:func:`conv_epilogue_` rewrites a ``channels_last`` bf16 conv output ``a``
in place with

    ``act(a * scale + shift (+ residual | + residual * residual_scale))``

computed in fp32 per channel and rounded once to bf16.  On CUDA it launches
the hand-written kernel ``csrc/conv_epilogue.cu``; on the CPU it takes the
plain version, :func:`conv_epilogue_reference`, which the kernel equals bit
for bit.  :func:`bn_params` gives a frozen batch norm's fp32 scale and
shift (with a downsample branch's batch norm merged into the shift, its
scale kept for the residual), kept with the module and computed again only
after a change to its buffers.  :func:`applies` says whether the kernel
takes a tensor; ``models/resnet.py::bn_epilogue`` runs the kernel where it
does and the chain of torch ops elsewhere.

No-grad paths only: the pass has no backward and writes in place, so the
wrapper raises when grad mode is on and an operand requires grad.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Optional, Tuple

import torch

from incremental_multimodal_medical_learning_ii_torch.ops.cuda_build import current_stream, launcher
from incremental_multimodal_medical_learning_ii_torch.utils.profiling import count

VEC = 8  # bf16 values in one 16-byte access: C must be a multiple of it
MAX_CHANNELS = 2048  # one thread a group of 8 channels, 256 threads a block
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]

__all__ = ["applies", "bn_params", "conv_epilogue_", "conv_epilogue_reference"]


def conv_epilogue_reference(a: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                            residual: Optional[torch.Tensor] = None,
                            residual_scale: Optional[torch.Tensor] = None,
                            relu: bool = True) -> torch.Tensor:
    """Plain version: a new tensor of ``a``'s type and memory format.  Each
    product and sum is one fp32 rounding, in the kernel's order; the result
    is rounded once to ``a``'s type."""
    y = a.to(torch.float32) * scale.view(1, -1, 1, 1)
    y = y + shift.view(1, -1, 1, 1)
    if residual is not None:
        r = residual.to(torch.float32)
        y = y + (r if residual_scale is None else r * residual_scale.view(1, -1, 1, 1))
    if relu:
        y = torch.relu(y)
    return y.to(a.dtype)


def _is_nhwc_bf16(t: torch.Tensor) -> bool:
    return (t.dtype == torch.bfloat16 and t.dim() == 4
            and t.is_contiguous(memory_format=torch.channels_last) and t.data_ptr() % 16 == 0)


def _refusal(a: torch.Tensor, residual: Optional[torch.Tensor]) -> Optional[str]:
    """Why the kernel does not take ``a`` (and ``residual``); None if it does."""
    if not _is_nhwc_bf16(a):
        return (f"expected a 16-byte aligned channels_last bf16 (N, C, H, W) tensor, got "
                f"{a.dtype} {tuple(a.shape)} strides {a.stride()}")
    c = a.shape[1]
    if c % VEC or c > MAX_CHANNELS:
        return f"the channel count must be a multiple of {VEC} up to {MAX_CHANNELS}, got {c}"
    if residual is not None and (residual.shape != a.shape or residual.device != a.device
                                 or not _is_nhwc_bf16(residual)):
        return (f"the residual must be a tensor like a ({tuple(a.shape)} on {a.device}), got "
                f"{residual.dtype} {tuple(residual.shape)} on {residual.device}, "
                f"strides {residual.stride()}")
    return None


def _needs_grad(*ts: Optional[torch.Tensor]) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in ts)


def applies(a: torch.Tensor, residual: Optional[torch.Tensor] = None) -> bool:
    """Whether the kernel takes this conv output (and residual): a CUDA
    bf16 ``channels_last`` tensor, C a multiple of 8 up to 2048, with no
    gradient to carry."""
    return a.is_cuda and not _needs_grad(a, residual) and _refusal(a, residual) is None


def conv_epilogue_(a: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                   residual: Optional[torch.Tensor] = None,
                   residual_scale: Optional[torch.Tensor] = None,
                   relu: bool = True) -> torch.Tensor:
    """Rewrite ``a`` in place with the epilogue and return it.  ``scale``,
    ``shift`` and ``residual_scale`` are (C,) fp32 on ``a``'s device;
    ``residual_scale`` needs a ``residual`` (without it the residual is
    added as it is).  Counts ``conv_epilogues`` in the open recorder, one
    a pass; ``conv_epilogue_.launches`` counts the kernel's launches."""
    if _needs_grad(a, residual):
        raise RuntimeError("conv_epilogue_ writes in place and has no backward: run it under "
                           "torch.no_grad(), or use the chain of torch ops where gradients flow")
    if a.device.type not in ("cuda", "cpu"):
        raise ValueError(f"conv_epilogue_ runs on cuda or cpu, not {a.device}")
    why = _refusal(a, residual)
    if why is not None:
        raise ValueError(f"conv_epilogue_: {why}")
    if residual_scale is not None and residual is None:
        raise ValueError("conv_epilogue_: a residual_scale needs a residual")
    c = a.shape[1]
    for name, p in (("scale", scale), ("shift", shift), ("residual_scale", residual_scale)):
        if p is not None and (p.dtype != torch.float32 or p.shape != (c,) or not p.is_contiguous()
                              or p.device != a.device):
            raise ValueError(f"conv_epilogue_: {name} must be contiguous float32 ({c},) on "
                             f"{a.device}, got {p.dtype} {tuple(p.shape)} on {p.device}")
    if a.is_cuda:
        fn = launcher("conv_epilogue", "conv_epilogue_launch", _ARGTYPES)
        rc = fn(a.data_ptr(), None if residual is None else residual.data_ptr(), scale.data_ptr(),
                None if residual_scale is None else residual_scale.data_ptr(), shift.data_ptr(),
                a.numel() // c, c, int(relu), current_stream(a))
        if rc != 0:
            raise RuntimeError(f"conv_epilogue kernel launch failed: CUDA error {rc}")
        conv_epilogue_.launches += 1
    else:
        a.copy_(conv_epilogue_reference(a, scale, shift, residual, residual_scale, relu))
    count("conv_epilogues")
    return a


conv_epilogue_.launches = 0

_PARAMS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def bn_params(bn, residual_bn=None) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """``(scale, shift, residual_scale)`` in fp32 of a frozen batch norm
    (``models/resnet.py::FrozenBatchNorm.affine``) and, where the residual
    is a downsample conv's raw output, of that branch's batch norm: its
    shift merged into ``shift``, its scale returned for the residual
    (``None`` without ``residual_bn``).  Kept with ``bn`` and computed again
    only when a buffer of either has changed: in place (a new tensor
    version), or replaced, or moved to another device (new storage)."""
    mods = (bn,) if residual_bn is None else (bn, residual_bn)
    key = tuple((t.data_ptr(), t.device, t._version) for m in mods for t in m.buffers())
    hit = _PARAMS.get(bn)
    if hit is None or hit[0] != key:
        scale, shift = bn.affine()
        residual_scale = None
        if residual_bn is not None:
            residual_scale, residual_shift = residual_bn.affine()
            shift = shift + residual_shift
        hit = _PARAMS[bn] = (key, (scale, shift, residual_scale))
    return hit[1]
