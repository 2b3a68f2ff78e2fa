"""Ring attention: exact attention with the sequence sharded over a mesh
axis (counterpart of the JAX package's ``ops/ring_attention.py``).

Each rank keeps its Q chunk and passes its K/V chunk around the ring of
the ``seq`` axis with :func:`parallel.mesh.ppermute`, accumulating the
softmax online (the flash-attention recurrence, blocked over ranks instead
of tiles).  A rank holds O(S / n) activations and one (Sl x Sl) score
block; the (S x S) matrix never exists anywhere.

The JAX semantics are kept: scores and accumulators in fp32 whatever the
input type; a finite ``_NEG`` fill, not ``-inf``, so a chunk whose keys are
all padding contributes exactly 0; an int32 validity chunk rotating with
K and V; ``n - 1`` hops and no trailing rotation; the output divided by
``max(l, 1e-30)``.  Plain torch (the JAX version is not a Pallas kernel);
differentiable, since ``ppermute`` is.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from incremental_multimodal_medical_learning_ii_torch.parallel.mesh import Mesh, ppermute

# a large finite negative for masked scores (not -inf: an all-padding
# chunk would then weigh garbage with exp(0) = 1)
_NEG = -0.7 * float(np.finfo(np.float32).max)


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_valid: torch.Tensor,
    mesh: Mesh,
    axis_name: str,
    sm_scale: float,
) -> torch.Tensor:
    """Attention of this rank's ``(B, nh, Sl, hd)`` queries over every
    rank's keys and values along ``axis_name``; ``kv_valid`` ``(B, Sl)`` is
    1 where this rank's key positions are real tokens.  Returns ``(B, nh,
    Sl, hd)`` in ``q``'s type.  Padded query rows attend whatever is valid
    and are never read by callers (the CLS readout and MLM fill read real
    positions)."""
    n_shards = mesh.along(axis_name).size
    b, nh, sl, hd = q.shape
    qf = q.float()
    m = torch.full((b, nh, sl), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, nh, sl), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, nh, sl, hd), dtype=torch.float32, device=q.device)
    kv = torch.stack([k, v])  # one hop carries both
    valid = kv_valid.to(torch.int32)
    for hop in range(n_shards):
        scores = torch.einsum("bnqd,bnkd->bnqk", qf, kv[0].float()) * sm_scale
        vmask = (valid != 0)[:, None, None, :]
        scores = torch.where(vmask, scores, _NEG)
        m_new = torch.maximum(m, torch.amax(scores, dim=-1))
        p = torch.where(vmask, torch.exp(scores - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        o = o * corr[..., None] + torch.einsum("bnqk,bnkd->bnqd", p, kv[1].float())
        m = m_new
        if hop < n_shards - 1:  # the last chunk is consumed where it lands
            kv = ppermute(mesh, axis_name, kv)
            valid = ppermute(mesh, axis_name, valid)
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype)


def ring_attention_core(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask_bias: torch.Tensor,
    *,
    mesh: Mesh,
    axis_name: str,
) -> torch.Tensor:
    """The ``attention_core`` hook of ``models/cxr_bert.py::bert_encode``:
    ``mask_bias`` is the local chunk's additive bias ``(B, 1, 1, Sl)`` (0
    attended, finfo.min padded), from which the validity chunk that rides
    the ring is derived."""
    kv_valid = mask_bias[:, 0, 0, :] == 0
    return ring_attention(q, k, v, kv_valid, mesh, axis_name,
                          sm_scale=1.0 / math.sqrt(q.shape[-1]))
