"""Tensor parallelism (Megatron) for the CXR-BERT text tower on a 2-D
``(data, model)`` mesh (counterpart of the JAX package's ``parallel/tp.py``).

Batches shard over ``data``; attention heads and FFN units over ``model``.
The JAX package places the weights with sharding annotations and lets
GSPMD insert the two all-reduces a layer.  Here each rank holds its shard
(:func:`shard_bert_tp`) and the encode writes the collectives out, through
the hooks of ``models/cxr_bert.py``:

* column-parallel q, k, v and ``ffn_in``: a rank holds their output rows
  for its ``num_heads / model`` heads (each 64 wide) and its units; the
  input goes through :func:`parallel.mesh.pvary` (identity forward, the
  gradient summed over ``model`` backward);
* row-parallel ``attn_out`` and ``ffn_out``: a rank holds their input
  columns; the partial product goes through :func:`parallel.mesh.psum`
  (the all-reduce forward, identity backward) and the bias is added once,
  after it.

``nn.Linear.weight`` is ``(out, in)``, the transpose of the JAX kernels:
column-parallel slices a weight's rows, row-parallel its columns.
Embeddings, LayerNorms and the heads are replicated.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional

import torch
import torch.nn as nn

from incremental_multimodal_medical_learning_ii_torch.models.cxr_bert import (
    BertDims,
    CXRBert,
    bert_encode,
    project_cls,
)
from incremental_multimodal_medical_learning_ii_torch.parallel.mesh import (
    DATA_AXIS,
    Mesh,
    all_reduce_sum,
    batch_rows,
    create_mesh,
    gather_rows,
    psum,
    pvary,
)

MODEL_AXIS = "model"

COLUMN = ("q", "k", "v", "ffn_in")
ROW = ("attn_out", "ffn_out")


def create_mesh_2d(data: int, model: int, devices=None, backend: Optional[str] = None) -> Mesh:
    """This rank's ``(data, model)`` mesh; ``model`` is the fast-varying
    axis (:func:`parallel.mesh.create_mesh`)."""
    return create_mesh((data, model), devices=devices, backend=backend,
                       axis_names=(DATA_AXIS, MODEL_AXIS))


def bert_tp_specs(model: CXRBert) -> Dict[str, Optional[int]]:
    """Which slice a rank holds of each parameter: the dimension split over
    ``model``, or ``None`` for a replicated one.  Column-parallel weights
    and biases split dim 0; row-parallel weights dim 1, their biases
    replicated (added after the all-reduce)."""
    specs = {}
    for name, _ in model.named_parameters():
        parts = name.split(".")
        spec = None
        if parts[0] == "layers" and parts[2] in COLUMN:
            spec = 0
        elif parts[0] == "layers" and parts[2] in ROW and parts[3] == "weight":
            spec = 1
        specs[name] = spec
    return specs


def check_tp_divisibility(dims: BertDims, model_size: int) -> None:
    if dims.num_heads % model_size:
        raise ValueError(
            f"num_heads={dims.num_heads} not divisible by model axis {model_size}"
        )
    if dims.intermediate_size % model_size:
        raise ValueError(
            f"intermediate_size={dims.intermediate_size} not divisible by "
            f"model axis {model_size}"
        )


def shard_bert_tp(model: CXRBert, mesh: Mesh) -> CXRBert:
    """This rank's shard of ``model`` on its device: a copy whose
    column- and row-parallel linears hold the rank's slices
    (:func:`bert_tp_specs`).  ``model`` is left as it is."""
    n = mesh.shape[MODEL_AXIS]
    check_tp_divisibility(model.dims, n)
    i = mesh.axis_index(MODEL_AXIS)
    shard = copy.deepcopy(model)
    modules = dict(shard.named_modules())
    with torch.no_grad():
        for name, dim in bert_tp_specs(model).items():
            if dim is None:
                continue
            owner, attr = name.rsplit(".", 1)
            layer = modules[owner]
            part = getattr(layer, attr).chunk(n, dim)[i].clone()
            setattr(layer, attr, nn.Parameter(part, requires_grad=False))
            if attr == "weight":
                layer.out_features, layer.in_features = part.shape
    return shard.to(mesh.device)


def make_tp_text_encode(dims: BertDims, mesh: Mesh, normalize: bool = True,
                        dtype: Optional[torch.dtype] = None):
    """``encode(shard, (B, S) ids, (B, S) mask) -> (B, proj)`` [CLS]
    projections on every rank, in global row order: this rank encodes its
    ``data`` rows with its heads and units (two all-reduces a layer over
    ``model``), projects them, and the rows are gathered over ``data``.
    ``dtype`` composes as everywhere (bf16 layer stack; fp32 softmax, LN
    moments and projection head).  Every rank of the mesh calls it."""
    n = mesh.shape[MODEL_AXIS]
    check_tp_divisibility(dims, n)
    data = mesh.along(DATA_AXIS)
    hooks = dict(num_heads=dims.num_heads // n,
                 column_input=lambda t: pvary(mesh, MODEL_AXIS, t),
                 row_output=lambda t: psum(mesh, MODEL_AXIS, t))

    def encode(shard: CXRBert, input_ids: torch.Tensor, attention_mask: torch.Tensor):
        rows = input_ids.shape[0]
        ids = batch_rows(data, input_ids).to(mesh.device)
        mask = batch_rows(data, attention_mask).to(mesh.device)
        hidden = bert_encode(shard, ids, mask, dtype=dtype or torch.float32, **hooks)
        proj = project_cls(shard, hidden[:, 0, :].float(), normalize)
        return gather_rows(data, proj, rows)

    return encode


def full_gradients(mesh: Mesh, shard: CXRBert) -> Dict[str, torch.Tensor]:
    """``{name: gradient}`` of the whole model's parameters after a
    backward through the encode, on every rank, as ``jax.grad`` of the
    partitioned encode gives it: each sharded parameter's slices gathered
    over ``model`` (the replicated ones' gradients are the same on every
    ``model`` rank), then each summed over ``data`` (a rank's rows)."""
    n, i = mesh.shape[MODEL_AXIS], mesh.axis_index(MODEL_AXIS)
    data, model = mesh.along(DATA_AXIS), mesh.along(MODEL_AXIS)
    params, out = dict(shard.named_parameters()), {}
    for name, dim in bert_tp_specs(shard).items():
        p = params[name]
        g = torch.zeros_like(p) if p.grad is None else p.grad.clone()
        if dim is not None:
            size = list(g.shape)
            size[dim] *= n
            whole = g.new_zeros(size)
            whole.narrow(dim, i * g.shape[dim], g.shape[dim]).copy_(g)
            g = all_reduce_sum(model, whole)
        out[name] = all_reduce_sum(data, g)
    return out
