"""CXR-BERT text encoder (counterpart of the JAX package's
``models/cxr_bert.py``).

A post-LN BERT encoder (``BertForMaskedLM`` semantics) whose last hidden
state's [CLS] vector goes through the CXR-BERT projection head (Linear
hidden->128, exact GELU, LayerNorm eps 1e-12, Linear 128->128) to the
128-d joint-space text embedding, not normalised unless asked.  The MLM
head serves ``predict_masked_tokens``.

Modules hold the weights (``nn.Linear`` layout, ``(out, in)``); the
module-level functions run them with the JAX package's knobs:

* ``dtype`` (fp32 default): bf16 runs the layer-stack matmuls in bf16;
  LayerNorm moments, the attention softmax and the projection head stay
  in fp32, and the dense path's ``scores + mask_bias`` promotes to fp32 as
  JAX does;
* ``fuse_qkv``: Q, K and V as one ``(H, 3H)`` product;
* ``attention_core``: a ``(q, k, v, mask_bias) -> ctx`` hook that replaces
  the attention inner op (the sequence-parallel ring path plugs in here);
* ``num_heads``, ``column_input`` and ``row_output``: the tensor-parallel
  hooks (``parallel/tp.py``).  A rank's shard holds ``num_heads`` of the
  heads (their width stays ``dims.head_dim``) and slices of the FFN;
  ``column_input`` wraps the input of the column-parallel linears (q, k,
  v, ``ffn_in``) and ``row_output`` the product of the row-parallel ones
  (``attn_out``, ``ffn_out``), whose bias is added after it, once;
* ``use_flash_attention``: the flash-attention kernel
  (``ops/flash_attention.py``) with key padding as segment ids, for report
  lengths; padded query rows then attend only padding, and their outputs
  are never read.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from incremental_multimodal_medical_learning_ii_torch.ops.flash_attention import flash_attention

LN_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class BertDims:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    projection_size: int = 128

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def tiny_bert_dims(**kw) -> BertDims:
    """Small dims for tests."""
    defaults = dict(
        vocab_size=99, hidden_size=32, num_layers=2, num_heads=4,
        intermediate_size=64, max_position_embeddings=64, projection_size=16,
    )
    defaults.update(kw)
    return BertDims(**defaults)


class Embeddings(nn.Module):
    def __init__(self, dims: BertDims):
        super().__init__()
        self.word = nn.Embedding(dims.vocab_size, dims.hidden_size)
        self.position = nn.Embedding(dims.max_position_embeddings, dims.hidden_size)
        self.token_type = nn.Embedding(dims.type_vocab_size, dims.hidden_size)
        self.ln = nn.LayerNorm(dims.hidden_size, eps=LN_EPS)


class EncoderLayer(nn.Module):
    def __init__(self, dims: BertDims):
        super().__init__()
        h, i = dims.hidden_size, dims.intermediate_size
        self.q = nn.Linear(h, h)
        self.k = nn.Linear(h, h)
        self.v = nn.Linear(h, h)
        self.attn_out = nn.Linear(h, h)
        self.attn_ln = nn.LayerNorm(h, eps=LN_EPS)
        self.ffn_in = nn.Linear(h, i)
        self.ffn_out = nn.Linear(i, h)
        self.ffn_ln = nn.LayerNorm(h, eps=LN_EPS)


class MLMHead(nn.Module):
    """Transform + tied-embedding decoder (the decoder weight is the word table)."""

    def __init__(self, dims: BertDims):
        super().__init__()
        self.transform_dense = nn.Linear(dims.hidden_size, dims.hidden_size)
        self.transform_ln = nn.LayerNorm(dims.hidden_size, eps=LN_EPS)
        self.decoder_bias = nn.Parameter(torch.zeros(dims.vocab_size))


class ProjectionHead(nn.Module):
    """``BertProjectionHead`` (the reference's ``modelling_cxrbert.py:36-49``)."""

    def __init__(self, dims: BertDims):
        super().__init__()
        self.dense_to_hidden = nn.Linear(dims.hidden_size, dims.projection_size)
        self.ln = nn.LayerNorm(dims.projection_size, eps=LN_EPS)
        self.dense_to_output = nn.Linear(dims.projection_size, dims.projection_size)


class CXRBert(nn.Module):
    """The frozen text tower; ``cls_projection`` is None for a checkpoint
    without the CXR-BERT projection head."""

    def __init__(self, dims: BertDims, projection: bool = True):
        super().__init__()
        self.dims = dims
        self.embeddings = Embeddings(dims)
        self.layers = nn.ModuleList(EncoderLayer(dims) for _ in range(dims.num_layers))
        self.mlm_head = MLMHead(dims)
        self.cls_projection = ProjectionHead(dims) if projection else None
        self.requires_grad_(False)
        self.eval()


@torch.no_grad()
def init_cxr_bert(generator: Optional[torch.Generator] = None,
                  dims: BertDims = BertDims()) -> CXRBert:
    """Seeded random weights at ``dims``, on the CPU, with the JAX init's
    distributions: N(0, 0.02) tables and matrices, zero biases, identity
    LayerNorms."""
    generator = generator or torch.Generator().manual_seed(0)
    model = CXRBert(dims)
    for module in model.modules():
        if isinstance(module, (nn.Linear, nn.Embedding)):
            module.weight.normal_(0.0, 0.02, generator=generator)
        if isinstance(module, nn.Linear):
            module.bias.zero_()
    return model


# ----------------------------------------------------------------------
# Forward
# ----------------------------------------------------------------------
def _linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    # the weight follows the activation's type: bf16 matmuls under bf16
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


def _layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    # moments always in fp32 (required for the bf16 path)
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias, ln.eps).to(x.dtype)


def _row_linear(layer: nn.Linear, x: torch.Tensor, row_output: Optional[Callable]) -> torch.Tensor:
    """A row-parallel linear: the partial product through ``row_output``
    (the all-reduce), then the bias once."""
    if row_output is None:
        return _linear(layer, x)
    return row_output(F.linear(x, layer.weight.to(x.dtype))) + layer.bias.to(x.dtype)


def _self_attention(
    layer: EncoderLayer,
    x: torch.Tensor,
    mask_bias: torch.Tensor,
    dims: BertDims,
    use_flash: bool = False,
    fuse_qkv: bool = False,
    attention_core: Optional[Callable] = None,
    num_heads: Optional[int] = None,
    row_output: Optional[Callable] = None,
) -> torch.Tensor:
    b, s, _ = x.shape
    nh, hd = num_heads or dims.num_heads, dims.head_dim
    width = nh * hd

    def split_heads(t):
        return t.reshape(b, s, nh, hd).transpose(1, 2)  # (B, nh, S, hd), a view

    if fuse_qkv:
        # q, k and v each hold this rank's heads: the fused product is split
        # at the heads' width, never in thirds of a full-width weight
        weight = torch.cat([layer.q.weight, layer.k.weight, layer.v.weight])
        bias = torch.cat([layer.q.bias, layer.k.bias, layer.v.bias])
        qkv = F.linear(x, weight.to(x.dtype), bias.to(x.dtype))
        q, k, v = (split_heads(t) for t in qkv.split(width, dim=-1))
    else:
        q = split_heads(_linear(layer.q, x))
        k = split_heads(_linear(layer.k, x))
        v = split_heads(_linear(layer.v, x))
    if attention_core is not None:
        ctx = attention_core(q, k, v, mask_bias)
    elif use_flash:
        # key padding as segment ids: no (B, nh, S, S) bias is built
        valid = (mask_bias[:, 0, 0, :] == 0).to(torch.int32)  # (B, S)
        ctx = flash_attention(q, k, v, valid, valid, sm_scale=1.0 / math.sqrt(hd))
    else:
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
        scores = scores + mask_bias  # (B, 1, 1, S) fp32: bf16 scores promote
        probs = torch.softmax(scores.float(), dim=-1).to(x.dtype)
        ctx = torch.matmul(probs, v)
    ctx = ctx.transpose(1, 2).reshape(b, s, width)
    return _row_linear(layer.attn_out, ctx, row_output)


def embed_inputs(
    model: CXRBert,
    input_ids: torch.Tensor,
    token_type_ids: Optional[torch.Tensor] = None,
    dtype: torch.dtype = torch.float32,
    position_offset: int = 0,
) -> torch.Tensor:
    """Word + position + token-type embeddings, LayerNormed: (B, S) -> (B, S, H).

    ``position_offset`` shifts the position-embedding slice for callers
    whose ``input_ids`` are a sequence shard."""
    s = input_ids.shape[1]
    emb = model.embeddings
    ids = input_ids.long()
    x = emb.word.weight[ids] + emb.position.weight[position_offset:position_offset + s][None]
    tt = token_type_ids.long() if token_type_ids is not None else torch.zeros_like(ids)
    x = x + emb.token_type.weight[tt]
    return _layer_norm(emb.ln, x).to(dtype)


def attention_mask_bias(attention_mask: torch.Tensor) -> torch.Tensor:
    """HF-style additive mask (B, 1, 1, S): 0 attended, finfo.min padded."""
    return (1.0 - attention_mask.float())[:, None, None, :] * torch.finfo(torch.float32).min


def encoder_layer(
    layer: EncoderLayer,
    x: torch.Tensor,
    mask_bias: torch.Tensor,
    dims: BertDims,
    use_flash: bool = False,
    fuse_qkv: bool = False,
    attention_core: Optional[Callable] = None,
    num_heads: Optional[int] = None,
    column_input: Optional[Callable] = None,
    row_output: Optional[Callable] = None,
) -> torch.Tensor:
    """One post-LN BERT block: attention + residual LN + FFN + residual LN."""
    col = column_input or (lambda t: t)
    attn = _self_attention(layer, col(x), mask_bias, dims, use_flash=use_flash,
                           fuse_qkv=fuse_qkv, attention_core=attention_core,
                           num_heads=num_heads, row_output=row_output)
    x = _layer_norm(layer.attn_ln, x + attn)
    ffn = _row_linear(layer.ffn_out, F.gelu(_linear(layer.ffn_in, col(x))), row_output)
    return _layer_norm(layer.ffn_ln, x + ffn)


def bert_encode(
    model: CXRBert,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    token_type_ids: Optional[torch.Tensor] = None,
    use_flash_attention: bool = False,
    dtype: torch.dtype = torch.float32,
    fuse_qkv: bool = False,
    attention_core: Optional[Callable] = None,
    position_offset: int = 0,
    num_heads: Optional[int] = None,
    column_input: Optional[Callable] = None,
    row_output: Optional[Callable] = None,
) -> torch.Tensor:
    """(B, S) ids + mask -> (B, S, H) last hidden state in ``dtype``."""
    x = embed_inputs(model, input_ids, token_type_ids, dtype=dtype,
                     position_offset=position_offset)
    mask_bias = attention_mask_bias(attention_mask)
    for layer in model.layers:
        x = encoder_layer(layer, x, mask_bias, model.dims, use_flash=use_flash_attention,
                          fuse_qkv=fuse_qkv, attention_core=attention_core,
                          num_heads=num_heads, column_input=column_input, row_output=row_output)
    return x


def cls_projection(model: CXRBert, cls_hidden: torch.Tensor) -> torch.Tensor:
    """The projection head on (B, H) fp32 [CLS] states -> (B, projection_size)."""
    p = model.cls_projection
    h = F.gelu(_linear(p.dense_to_hidden, cls_hidden))
    return _linear(p.dense_to_output, _layer_norm(p.ln, h))


def get_projected_text_embeddings(
    model: CXRBert,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    normalize: bool = False,
    dtype: torch.dtype = torch.float32,
    fuse_qkv: bool = False,
    use_flash_attention: bool = False,
) -> torch.Tensor:
    """(B, S) -> (B, projection_size) fp32: [CLS] of the last hidden state
    through the projection head; the head and the L2 normalisation always
    run in fp32."""
    hidden = bert_encode(model, input_ids, attention_mask, dtype=dtype, fuse_qkv=fuse_qkv,
                         use_flash_attention=use_flash_attention)
    return project_cls(model, hidden[:, 0, :].float(), normalize)


def project_cls(model: CXRBert, cls_hidden: torch.Tensor, normalize: bool) -> torch.Tensor:
    """(B, H) fp32 [CLS] states -> the (B, projection_size) embeddings,
    L2-normalised if asked."""
    proj = cls_projection(model, cls_hidden)
    if normalize:
        proj = proj / torch.clamp(torch.linalg.norm(proj, dim=-1, keepdim=True), min=1e-12)
    return proj


def mlm_logits(model: CXRBert, hidden: torch.Tensor) -> torch.Tensor:
    """BertForMaskedLM prediction head: (B, S, H) -> (B, S, vocab) fp32."""
    head = model.mlm_head
    h = F.gelu(_linear(head.transform_dense, hidden))
    h = _layer_norm(head.transform_ln, h)
    return torch.matmul(h.float(), model.embeddings.word.weight.T) + head.decoder_bias
