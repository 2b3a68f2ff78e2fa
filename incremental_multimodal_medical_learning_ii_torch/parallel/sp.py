"""Sequence parallelism (ring attention) for the CXR-BERT text tower on a
2-D ``(data, seq)`` mesh (counterpart of the JAX package's ``parallel/sp.py``).

Each rank holds ``S / seq`` tokens of its ``B / data`` rows.  Every
per-token op (embeddings, LayerNorm, FFN, the Q/K/V projections) runs on
the rank's tokens alone; attention, the one op across tokens, runs as an
exact ring (``ops/ring_attention.py``) whose K/V chunks hop around the
``seq`` axis.  A rank's activations fall from O(S) to O(S / seq) and the
(S x S) score matrix never exists.

The [CLS] column lives on the ``seq`` rank 0 of each row; the projection
head runs on every rank after the [CLS] states are gathered, so the result
is replicated.  Combining this with tensor parallelism is out of scope, as
in the JAX package (prompt banks are short; this exists for reports).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import numpy as np
import torch

from incremental_multimodal_medical_learning_ii_torch.models.cxr_bert import (
    BertDims,
    CXRBert,
    bert_encode,
    project_cls,
)
from incremental_multimodal_medical_learning_ii_torch.ops.ring_attention import (
    ring_attention_core,
)
from incremental_multimodal_medical_learning_ii_torch.parallel.mesh import (
    DATA_AXIS,
    Mesh,
    create_mesh,
    gather_rows,
    psum,
    sum_gradients,
)

SEQ_AXIS = "seq"


def create_mesh_sp(data: int, seq: int, devices=None, backend: Optional[str] = None) -> Mesh:
    """This rank's ``(data, seq)`` mesh; ``seq`` is the fast-varying axis,
    so the ring's hops run between neighbouring ranks."""
    return create_mesh((data, seq), devices=devices, backend=backend,
                       axis_names=(DATA_AXIS, SEQ_AXIS))


def pad_tokens_for_sp(input_ids, attention_mask, seq_shards: int):
    """Pad (B, S) ids/mask on the sequence axis to a multiple of the seq
    mesh size (id 0, mask 0: the ring masks padded keys as the dense path's
    additive bias does).  Returns numpy arrays."""
    ids = np.asarray(input_ids)
    mask = np.asarray(attention_mask)
    s = ids.shape[1]
    s_pad = ((s + seq_shards - 1) // seq_shards) * seq_shards
    if s_pad != s:
        ids = np.pad(ids, ((0, 0), (0, s_pad - s)))
        mask = np.pad(mask, ((0, 0), (0, s_pad - s)))
    return ids, mask


def check_sp_shapes(dims: BertDims, batch: int, seq_len: int, mesh: Mesh) -> None:
    n_data = mesh.shape[DATA_AXIS]
    n_seq = mesh.shape[SEQ_AXIS]
    if batch % n_data:
        raise ValueError(f"batch {batch} not divisible by data axis {n_data}")
    if seq_len % n_seq:
        raise ValueError(
            f"seq len {seq_len} not divisible by seq axis {n_seq} "
            f"(pad with pad_tokens_for_sp)"
        )
    if seq_len > dims.max_position_embeddings:
        raise ValueError(
            f"seq len {seq_len} exceeds max_position_embeddings="
            f"{dims.max_position_embeddings}"
        )


def make_sp_text_encode(dims: BertDims, mesh: Mesh, normalize: bool = True,
                        dtype: Optional[torch.dtype] = None):
    """``encode(model, (B, S) ids, (B, S) mask) -> (B, proj)`` [CLS]
    projections on every rank: this rank runs ``bert_encode`` on its
    ``(B / data, S / seq)`` tokens with the ring core and a position offset
    of ``seq_index * S / seq``; the [CLS] states are summed over ``seq``
    (only rank 0 of the axis holds them) and gathered over ``data``, then
    projected.  ``dtype`` composes as everywhere (bf16 layer stack; fp32
    softmax, ring accumulator and projection head).  Every rank calls it."""
    core = functools.partial(ring_attention_core, mesh=mesh, axis_name=SEQ_AXIS)
    data = mesh.along(DATA_AXIS)
    n_seq = mesh.shape[SEQ_AXIS]
    d, s_idx = data.rank, mesh.axis_index(SEQ_AXIS)

    def encode(model: CXRBert, input_ids: torch.Tensor, attention_mask: torch.Tensor):
        batch, seq_len = input_ids.shape
        check_sp_shapes(dims, batch, seq_len, mesh)
        b_l, s_l = batch // data.size, seq_len // n_seq
        rows, cols = slice(d * b_l, (d + 1) * b_l), slice(s_idx * s_l, (s_idx + 1) * s_l)
        ids = input_ids[rows, cols].to(mesh.device)
        mask = attention_mask[rows, cols].to(mesh.device)
        hidden = bert_encode(model, ids, mask, dtype=dtype or torch.float32,
                             attention_core=core, position_offset=s_idx * s_l)
        # the other seq ranks add zeros; multiplying keeps their hidden
        # states, and so their ring hops, in the graph, so every rank runs
        # the backward of every hop
        cls = hidden[:, 0, :].float() * (1.0 if s_idx == 0 else 0.0)
        cls = gather_rows(data, psum(mesh, SEQ_AXIS, cls), batch)
        return project_cls(model, cls, normalize)

    return encode


def full_gradients(mesh: Mesh, model: CXRBert) -> Dict[str, torch.Tensor]:
    """``{name: gradient}`` of every parameter of ``model`` after a
    backward through the encode, on every rank, as ``jax.grad`` of the
    partitioned encode gives it: each rank holds the part from its tokens
    and its rows, summed over the mesh; the projection head's, which every
    rank computes whole, as it is."""
    return sum_gradients(mesh, model.named_parameters(), whole=("cls_projection.",))
