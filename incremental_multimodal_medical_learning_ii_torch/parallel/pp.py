"""Pipeline parallelism (GPipe) for the CXR-BERT text tower on a 2-D
``(data, pipe)`` mesh (counterpart of the JAX package's ``parallel/pp.py``).

Stage ``s`` of the ``pipe`` axis runs layers ``[s·L/P, (s+1)·L/P)``
(:func:`stage_layers`, the role of the JAX ``stack_layer_params``).  A
rank's ``B / data`` rows split into ``M`` microbatches that stream through
the stages over ``M + P - 1`` ticks: at tick ``t`` stage ``s`` works on
microbatch ``t - s`` and hands its output to stage ``s + 1`` with
:func:`parallel.mesh.ppermute`; stage 0 embeds, the last stage banks the
[CLS] column, and a sum over ``pipe`` replicates the result (the other
stages contribute zeros), as the JAX ``psum`` does.

As in the JAX schedule every stage computes at every tick: in the fill and
drain ticks a stage works on a clamped microbatch whose result is not
banked (a ``torch.where`` on the tick, as JAX's).  Keeping those results
in the graph keeps the schedule differentiable: every rank then runs the
backward of every hop, in the same order, and each hop's gradient goes
back to the stage that sent it.  The embeddings and the projection head
are replicated.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from incremental_multimodal_medical_learning_ii_torch.models.cxr_bert import (
    BertDims,
    CXRBert,
    EncoderLayer,
    attention_mask_bias,
    embed_inputs,
    encoder_layer,
    project_cls,
)
from incremental_multimodal_medical_learning_ii_torch.parallel.mesh import (
    DATA_AXIS,
    Mesh,
    create_mesh,
    gather_rows,
    ppermute,
    psum,
    sum_gradients,
)

PIPE_AXIS = "pipe"


def create_mesh_pp(data: int, pipe: int, devices=None, backend: Optional[str] = None) -> Mesh:
    """This rank's ``(data, pipe)`` mesh; ``pipe`` is the fast-varying
    axis, so stage handoffs run between neighbouring ranks."""
    return create_mesh((data, pipe), devices=devices, backend=backend,
                       axis_names=(DATA_AXIS, PIPE_AXIS))


def stage_layers(model: CXRBert, mesh: Mesh) -> List[EncoderLayer]:
    """The contiguous layers this rank's stage runs."""
    per = model.dims.num_layers // mesh.shape[PIPE_AXIS]
    s = mesh.axis_index(PIPE_AXIS)
    return list(model.layers[s * per:(s + 1) * per])


def check_pp_shapes(dims: BertDims, batch: int, n_microbatches: int, mesh: Mesh) -> None:
    n_data = mesh.shape[DATA_AXIS]
    n_pipe = mesh.shape[PIPE_AXIS]
    if dims.num_layers % n_pipe:
        raise ValueError(
            f"num_layers={dims.num_layers} not divisible by pipe axis {n_pipe}"
        )
    if batch % n_data:
        raise ValueError(f"batch {batch} not divisible by data axis {n_data}")
    if (batch // n_data) % n_microbatches:
        raise ValueError(
            f"per-data-shard batch {batch // n_data} not divisible by "
            f"n_microbatches={n_microbatches}"
        )


def make_pp_text_encode(dims: BertDims, mesh: Mesh, n_microbatches: int, normalize: bool = True,
                        dtype: Optional[torch.dtype] = None):
    """``encode(model, (B, S) ids, (B, S) mask) -> (B, proj)`` [CLS]
    projections on every rank: this rank's stage of the GPipe schedule over
    its ``data`` rows, the banked [CLS] states summed over ``pipe`` and
    gathered over ``data``, then projected.  ``dtype`` composes as
    everywhere (bf16 layer stack; fp32 softmax, LN moments, [CLS] banking
    and projection head).  Every rank calls it."""
    n_pipe, m_count = mesh.shape[PIPE_AXIS], n_microbatches
    data = mesh.along(DATA_AXIS)
    s_idx = mesh.axis_index(PIPE_AXIS)
    ticks = m_count + n_pipe - 1
    compute_dtype = dtype or torch.float32

    def encode(model: CXRBert, input_ids: torch.Tensor, attention_mask: torch.Tensor):
        batch, seq_len = input_ids.shape
        check_pp_shapes(dims, batch, m_count, mesh)
        b_l = batch // data.size
        ids = input_ids[data.rank * b_l:(data.rank + 1) * b_l].to(mesh.device)
        mask = attention_mask[data.rank * b_l:(data.rank + 1) * b_l].to(mesh.device)
        mb = b_l // m_count
        layers = stage_layers(model, mesh)
        t_idx = torch.arange(ticks, device=mesh.device)
        # the ticks at which this stage banks a [CLS] column
        write = (t_idx >= s_idx) & (t_idx < s_idx + m_count) & (s_idx == n_pipe - 1)
        first = torch.ones((), dtype=torch.bool, device=mesh.device)
        held = torch.zeros((mb, seq_len, dims.hidden_size), dtype=compute_dtype,
                           device=mesh.device)
        out = [torch.zeros((mb, dims.hidden_size), device=mesh.device)] * m_count
        for t in range(ticks):
            m_c = min(max(t - s_idx, 0), m_count - 1)  # this stage's microbatch, clamped
            rows = slice(m_c * mb, (m_c + 1) * mb)
            x = held
            if s_idx == 0:  # the held hop stays in the graph (see the docstring)
                x = torch.where(first, embed_inputs(model, ids[rows], dtype=compute_dtype), held)
            mask_bias = attention_mask_bias(mask[rows])
            for layer in layers:
                x = encoder_layer(layer, x, mask_bias, dims)
            if t < ticks - 1:  # stage 0 receives zeros and uses its embedding
                held = ppermute(mesh, PIPE_AXIS, x, wrap=False)
            out[m_c] = torch.where(write[t], x[:, 0, :].float(), out[m_c])
        cls = psum(mesh, PIPE_AXIS, torch.cat(out))
        return project_cls(model, gather_rows(data, cls, batch), normalize)

    return encode


def full_gradients(mesh: Mesh, model: CXRBert) -> Dict[str, torch.Tensor]:
    """``{name: gradient}`` of every parameter of ``model`` after a
    backward through the encode, on every rank, as ``jax.grad`` of the
    partitioned encode gives it: each rank holds the part from its stage's
    layers (stage 0's: the embeddings) and its rows, summed over the mesh;
    the projection head's, which every rank computes whole, as it is."""
    return sum_gradients(mesh, model.named_parameters(), whole=("cls_projection.",))
