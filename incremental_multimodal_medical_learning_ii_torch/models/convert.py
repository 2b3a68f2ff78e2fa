"""Load the reference's own weight files into the port's modules
(counterpart of the JAX package's ``models/convert.py``).

* CXR-BERT: a HuggingFace ``BertForMaskedLM`` state dict plus the
  CXR-BERT ``cls_projection_head`` (``modelling_cxrbert.py:64-68``), as a
  raw ``torch.save`` file (:func:`load_cxr_bert_checkpoint`) or a local
  HF snapshot directory (:func:`load_cxr_bert_snapshot`: ``config.json``,
  ``model.safetensors`` or ``pytorch_model.bin``, ``vocab.txt`` and
  ``tokenizer_config.json``).  ``model.safetensors`` is read by this
  module's own reader (:func:`read_safetensors`).
* The BioViL image model: ``biovil_image_resnet50_proj_size_128.pt``
  (keys ``encoder.encoder.*`` for the ResNet-50 trunk and
  ``projector.model.*`` for the 1x1-conv MLP).  BioViL checkpoints exist
  with a ResNet-50 trunk only; a torchvision ResNet-18 state dict loads
  on its own (:func:`convert_resnet18_state_dict`).
* The reference's adapter checkpoints, whole pickled ``models.myMLP`` /
  ``models.myLinearModel`` modules (:func:`load_reference_adapter`).

The torch layouts are the port's own (``nn.Linear`` ``(out, in)``, OIHW
convs), so weights copy across unchanged; every copy checks its shape.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import struct
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn as nn

from incremental_multimodal_medical_learning_ii_torch.models.adapters import (
    LinearAdapter,
    MLPAdapter,
)
from incremental_multimodal_medical_learning_ii_torch.models.biovil_image import (
    BioViLImageModel,
)
from incremental_multimodal_medical_learning_ii_torch.models.cxr_bert import BertDims, CXRBert
from incremental_multimodal_medical_learning_ii_torch.models.resnet import (
    Conv2d,
    FrozenBatchNorm,
    ResNet18,
    ResNet50,
)
from incremental_multimodal_medical_learning_ii_torch.text.tokenizer import PromptTokenizer


@torch.no_grad()
def _copy(dst: torch.Tensor, src, key: str = "") -> None:
    src = torch.as_tensor(src).detach()
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{key}: shape {tuple(src.shape)} does not fit {tuple(dst.shape)}")
    dst.copy_(src.to(torch.float32))


def _linear(layer: nn.Linear, sd: Mapping, prefix: str) -> None:
    _copy(layer.weight, sd[prefix + ".weight"], prefix)
    _copy(layer.bias, sd[prefix + ".bias"], prefix)


def _ln(ln: nn.LayerNorm, sd: Mapping, prefix: str) -> None:
    _copy(ln.weight, sd[prefix + ".weight"], prefix)
    _copy(ln.bias, sd[prefix + ".bias"], prefix)


# ----------------------------------------------------------------------
# CXR-BERT
# ----------------------------------------------------------------------
def infer_bert_dims(sd: Mapping, projection_size: int = 128) -> BertDims:
    """Dims from the tensor shapes; heads assume BERT's head width of 64."""
    word = sd["bert.embeddings.word_embeddings.weight"].shape
    pos = sd["bert.embeddings.position_embeddings.weight"].shape
    tt = sd["bert.embeddings.token_type_embeddings.weight"].shape
    inter = sd["bert.encoder.layer.0.intermediate.dense.weight"].shape
    n_layers = 0
    while f"bert.encoder.layer.{n_layers}.attention.self.query.weight" in sd:
        n_layers += 1
    hidden = int(word[1])
    if "cls_projection_head.dense_to_hidden.weight" in sd:
        projection_size = int(sd["cls_projection_head.dense_to_hidden.weight"].shape[0])
    return BertDims(
        vocab_size=int(word[0]),
        hidden_size=hidden,
        num_layers=n_layers,
        num_heads=max(1, hidden // 64),
        intermediate_size=int(inter[0]),
        max_position_embeddings=int(pos[0]),
        type_vocab_size=int(tt[0]),
        projection_size=projection_size,
    )


def convert_cxr_bert_state_dict(sd: Mapping, num_heads: Optional[int] = None) -> CXRBert:
    """A ``BertForMaskedLM`` (+ projection head) state dict -> :class:`CXRBert`."""
    dims = infer_bert_dims(sd)
    if num_heads is not None:
        dims = dataclasses.replace(dims, num_heads=num_heads)
    model = CXRBert(dims, projection="cls_projection_head.dense_to_hidden.weight" in sd)
    emb = model.embeddings
    _copy(emb.word.weight, sd["bert.embeddings.word_embeddings.weight"], "word")
    _copy(emb.position.weight, sd["bert.embeddings.position_embeddings.weight"], "position")
    _copy(emb.token_type.weight, sd["bert.embeddings.token_type_embeddings.weight"], "token_type")
    _ln(emb.ln, sd, "bert.embeddings.LayerNorm")
    for li, layer in enumerate(model.layers):
        lp = f"bert.encoder.layer.{li}."
        _linear(layer.q, sd, lp + "attention.self.query")
        _linear(layer.k, sd, lp + "attention.self.key")
        _linear(layer.v, sd, lp + "attention.self.value")
        _linear(layer.attn_out, sd, lp + "attention.output.dense")
        _ln(layer.attn_ln, sd, lp + "attention.output.LayerNorm")
        _linear(layer.ffn_in, sd, lp + "intermediate.dense")
        _linear(layer.ffn_out, sd, lp + "output.dense")
        _ln(layer.ffn_ln, sd, lp + "output.LayerNorm")
    head = model.mlm_head
    _linear(head.transform_dense, sd, "cls.predictions.transform.dense")
    _ln(head.transform_ln, sd, "cls.predictions.transform.LayerNorm")
    bias_key = ("cls.predictions.decoder.bias" if "cls.predictions.decoder.bias" in sd
                else "cls.predictions.bias")
    _copy(head.decoder_bias, sd[bias_key], bias_key)
    if model.cls_projection is not None:
        proj = model.cls_projection
        _linear(proj.dense_to_hidden, sd, "cls_projection_head.dense_to_hidden")
        _ln(proj.ln, sd, "cls_projection_head.LayerNorm")
        _linear(proj.dense_to_output, sd, "cls_projection_head.dense_to_output")
    return model


def load_cxr_bert_checkpoint(path: str, num_heads: Optional[int] = None) -> CXRBert:
    """CXR-BERT from a raw torch state-dict file.  A state dict does not
    record the head count: prefer :func:`load_cxr_bert_snapshot`, whose
    ``config.json`` gives it."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return convert_cxr_bert_state_dict(sd, num_heads=num_heads)


_SAFETENSORS_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
                       "I64": torch.int64, "I32": torch.int32}


def read_safetensors(path) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file: an 8-byte little-endian header length, a
    JSON header ``{name: {dtype, shape, data_offsets}}``, then the raw
    little-endian tensor bytes.  F32, F16 and BF16 weights (and the I64 /
    I32 buffers an HF checkpoint may carry, such as ``position_ids``)."""
    data = bytearray(Path(path).read_bytes())
    (n,) = struct.unpack("<Q", data[:8])
    header = json.loads(data[8:8 + n])
    base = 8 + n
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name} has unsupported dtype {info['dtype']}")
        start, end = info["data_offsets"]
        count = 1
        for d in info["shape"]:
            count *= d
        if end - start != count * dtype.itemsize or base + end > len(data):
            raise ValueError(f"{path}: tensor {name} has a bad byte range {start}..{end}")
        flat = (torch.frombuffer(data, dtype=dtype, count=count, offset=base + start)
                if count else torch.empty(0, dtype=dtype))
        out[name] = flat.reshape(info["shape"])
    return out


def _load_snapshot_state_dict(directory: Path):
    """The weights of an HF snapshot dir: ``model.safetensors`` preferred,
    ``pytorch_model.bin`` otherwise."""
    st = directory / "model.safetensors"
    if st.exists():
        return read_safetensors(st)
    bin_path = directory / "pytorch_model.bin"
    if bin_path.exists():
        return torch.load(bin_path, map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"no model.safetensors or pytorch_model.bin in {directory}")


_TOKENIZER_KWARGS = {
    "do_lower_case", "do_basic_tokenize", "never_split", "unk_token", "sep_token",
    "pad_token", "cls_token", "mask_token", "tokenize_chinese_chars", "strip_accents",
}


def load_cxr_bert_snapshot(snapshot_dir) -> Tuple[CXRBert, Optional[PromptTokenizer]]:
    """CXR-BERT from a local HF snapshot directory, as the reference's hub
    download of ``microsoft/BiomedVLP-CXR-BERT-specialized`` leaves it.

    ``config.json`` gives the dims (the head count cannot be read from the
    tensors); a config that contradicts the tensors raises.  ``vocab.txt``,
    when present, builds the tokenizer with the ``tokenizer_config.json``
    settings the reference's ``from_pretrained`` honours.  Returns
    ``(model, tokenizer or None)``; ``model.dims`` is the config's."""
    d = Path(snapshot_dir)
    cfg = json.loads((d / "config.json").read_text())
    model = convert_cxr_bert_state_dict(_load_snapshot_state_dict(d),
                                        num_heads=int(cfg["num_attention_heads"]))
    inferred = model.dims
    dims = BertDims(
        vocab_size=int(cfg["vocab_size"]),
        hidden_size=int(cfg["hidden_size"]),
        num_layers=int(cfg["num_hidden_layers"]),
        num_heads=int(cfg["num_attention_heads"]),
        intermediate_size=int(cfg["intermediate_size"]),
        max_position_embeddings=int(cfg["max_position_embeddings"]),
        type_vocab_size=int(cfg.get("type_vocab_size", 2)),
        projection_size=int(cfg.get("projection_size", inferred.projection_size)),
    )
    for field in ("vocab_size", "hidden_size", "num_layers", "intermediate_size",
                  "max_position_embeddings", "type_vocab_size"):
        if getattr(inferred, field) != getattr(dims, field):
            raise ValueError(f"config.json says {field}={getattr(dims, field)} but the "
                             f"weights imply {getattr(inferred, field)}")
    if dims.hidden_size % dims.num_heads != 0:
        raise ValueError(f"hidden_size {dims.hidden_size} not divisible by "
                         f"num_attention_heads {dims.num_heads}")
    model.dims = dims
    tokenizer = None
    vocab = d / "vocab.txt"
    if vocab.exists():
        kwargs = {}
        tok_cfg = d / "tokenizer_config.json"
        if tok_cfg.exists():
            for k, v in json.loads(tok_cfg.read_text()).items():
                if k in _TOKENIZER_KWARGS:
                    # newer HF formats write special tokens as {"content": ...}
                    kwargs[k] = v["content"] if isinstance(v, dict) else v
        tokenizer = PromptTokenizer(vocab, max_allowed_input_length=dims.max_position_embeddings,
                                    **kwargs)
    return model, tokenizer


# ----------------------------------------------------------------------
# BioViL image model
# ----------------------------------------------------------------------
def _conv(conv: Conv2d, sd: Mapping, key: str) -> None:
    _copy(conv.weight, sd[key], key)


def _bn(bn: FrozenBatchNorm, sd: Mapping, prefix: str) -> None:
    for name, key in (("scale", "weight"), ("bias", "bias"), ("mean", "running_mean"),
                      ("var", "running_var")):
        _copy(getattr(bn, name), sd[f"{prefix}.{key}"], f"{prefix}.{key}")


@torch.no_grad()
def _load_trunk(enc, sd: Mapping, p: str) -> None:
    """A torchvision trunk's weights under ``p`` into ``enc`` (ResNet-50
    or ResNet-18)."""
    _conv(enc.conv1, sd, p + "conv1.weight")
    _bn(enc.bn1, sd, p + "bn1")
    for li in range(1, 5):
        for bi, block in enumerate(getattr(enc, f"layer{li}")):
            bp = f"{p}layer{li}.{bi}."
            for i in range(1, block.n_convs + 1):
                _conv(getattr(block, f"conv{i}"), sd, f"{bp}conv{i}.weight")
                _bn(getattr(block, f"bn{i}"), sd, f"{bp}bn{i}")
            if (block.downsample_conv is None) != (bp + "downsample.0.weight" not in sd):
                raise ValueError(f"{bp}: downsample does not match the architecture")
            if block.downsample_conv is not None:
                _conv(block.downsample_conv, sd, bp + "downsample.0.weight")
                _bn(block.downsample_bn, sd, bp + "downsample.1")


def convert_resnet18_state_dict(sd: Mapping, prefix: str = "") -> ResNet18:
    """A torchvision ResNet-18 (BasicBlock) state dict, optionally under
    ``prefix`` -> :class:`ResNet18`."""
    model = ResNet18(in_channels=sd[prefix + "conv1.weight"].shape[1])
    _load_trunk(model, sd, prefix)
    return model.eval()


def convert_resnet50_state_dict(sd: Mapping, prefix: str = "") -> ResNet50:
    """A torchvision ResNet-50 state dict, optionally under ``prefix`` ->
    :class:`ResNet50`."""
    model = ResNet50(in_channels=sd[prefix + "conv1.weight"].shape[1])
    _load_trunk(model, sd, prefix)
    return model.eval()


def convert_biovil_image_state_dict(sd: Mapping) -> BioViLImageModel:
    """The reference ``ImageModel`` state dict (ResNet-50 trunk under
    ``encoder.encoder.``, projector under ``projector.model.{0,1,3}``)."""
    p = "encoder.encoder."
    if p + "layer1.0.conv3.weight" not in sd:
        raise ValueError("not a ResNet-50 BioViL checkpoint (BioViL image checkpoints exist "
                         "with a ResNet-50 trunk only)")
    with torch.no_grad():
        model = BioViLImageModel(convert_resnet50_state_dict(sd, p))
        proj = model.projector
        _conv(proj.conv1, sd, "projector.model.0.weight")
        _bn(proj.bn, sd, "projector.model.1")
        _conv(proj.conv2, sd, "projector.model.3.weight")
        _copy(proj.conv2_bias, sd["projector.model.3.bias"], "projector.model.3.bias")
    return model.eval()


def load_biovil_image_checkpoint(path: str) -> BioViLImageModel:
    """The reference's ``biovil_image_resnet50_proj_size_128.pt``."""
    return convert_biovil_image_state_dict(torch.load(path, map_location="cpu", weights_only=True))


# ----------------------------------------------------------------------
# Reference adapter checkpoints
# ----------------------------------------------------------------------
@contextlib.contextmanager
def reference_models_stub():
    """Make the reference's pickled class paths (``models.myMLP`` /
    ``models.myLinearModel``, recorded by its whole-module ``torch.save``,
    Trainer.py:1643-1648) importable for the duration of a ``torch.load``,
    without leaving a stub in ``sys.modules`` that would shadow a real
    ``models`` module imported later.  A ``models`` module already loaded
    is used as it is."""
    import sys
    import types

    if "models" in sys.modules:
        yield
        return
    stub = types.ModuleType("models")

    class myMLP(nn.Module):  # noqa: N801 - pickled class name
        def __init__(self):
            super().__init__()
            self.layer = nn.Sequential(nn.Linear(128, 256), nn.ReLU(), nn.Linear(256, 128))

        def forward(self, x):  # models.py:12-14
            return self.layer(x)

    class myLinearModel(nn.Module):  # noqa: N801
        def __init__(self):
            super().__init__()
            self.layer = nn.Sequential(nn.Linear(128, 128))

        def forward(self, x):  # models.py:23-25
            return self.layer(x)

    stub.myMLP = myMLP
    stub.myLinearModel = myLinearModel
    sys.modules["models"] = stub
    try:
        yield
    finally:
        sys.modules.pop("models", None)


def load_reference_adapter(path: str) -> nn.Module:
    """A reference ``{image,text}_adapter.pt`` (a pickled whole module) ->
    :class:`MLPAdapter` (``layer.0``, ``layer.2``) or :class:`LinearAdapter`."""
    with reference_models_stub():
        module = torch.load(path, map_location="cpu", weights_only=False)
    sd = module.state_dict()
    if "layer.2.weight" in sd:
        adapter = MLPAdapter(sd["layer.0.weight"].shape[1], sd["layer.0.weight"].shape[0])
        _linear(adapter.dense2, sd, "layer.2")
    else:
        adapter = LinearAdapter(sd["layer.0.weight"].shape[1])
    _linear(adapter.dense1, sd, "layer.0")
    return adapter.eval()


# ----------------------------------------------------------------------
# Diagnostics
# ----------------------------------------------------------------------
def compare_params(a, b, atol: float = 0.0, verbose: bool = True) -> List[str]:
    """Entry-by-entry comparison of two modules' state dicts (or two state
    dicts): the reference's ``Trainer.compare_models`` diff
    (``Trainer.py:1287-1300``).  Returns the names of the entries that
    differ by more than ``atol``; prints a summary when verbose.  Raises
    when the two hold different entries."""
    sa = a.state_dict() if isinstance(a, nn.Module) else a
    sb = b.state_dict() if isinstance(b, nn.Module) else b
    if len(sa) != len(sb):
        raise ValueError(f"different structures: {len(sa)} vs {len(sb)} entries")
    mismatched = []
    for (ka, va), (kb, vb) in zip(sa.items(), sb.items()):
        if ka != kb:
            raise ValueError(f"key mismatch: {ka} vs {kb}")
        va = torch.as_tensor(va).detach().cpu().to(torch.float64)
        vb = torch.as_tensor(vb).detach().cpu().to(torch.float64)
        if va.shape != vb.shape or not torch.allclose(va, vb, atol=atol, rtol=0):
            mismatched.append(ka)
            if verbose:
                print("Mismatch found at", ka)
    if verbose and not mismatched:
        print("Params match perfectly! :)")
    return mismatched


@torch.no_grad()
def encoder_output_dim(forward_fn, model: nn.Module, input_hw: int = 32) -> int:
    """A trunk's output feature size from a forward of one zero image on
    the model's device (``get_encoder_output_dim``, ``model.py:231-247``)."""
    device = next(model.parameters()).device
    out = forward_fn(model, torch.zeros((1, input_hw, input_hw, 3), device=device))
    return int(out.shape[-1])
