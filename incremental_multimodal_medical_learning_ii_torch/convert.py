"""Carry the JAX package's parameters into the port's modules.

``params_from_jax`` takes a parameter tree as the JAX package holds it,
with numpy (or array-like) leaves, and returns the port's counterpart:

* a BioViL image tree ``{"encoder": ..., "projector": ...}`` becomes a
  :class:`BioViLImageModel` (conv kernels HWIO -> OIHW; BN
  ``{scale, bias, mean, var}`` kept by name; the projector's conv2 bias);
* an adapter tree ``{"image" | "text" | "shared": {"dense1": {"kernel",
  "bias"}, ...}}`` becomes an ``nn.ModuleDict`` of adapters (``kernel``
  (in, out) -> ``weight`` (out, in));
* a CXR-BERT tree (``init_cxr_bert`` layout: ``embeddings``, ``layers``,
  ``mlm_head``, optional ``cls_projection``) becomes a :class:`CXRBert`
  at the ``dims`` given (LayerNorm ``scale`` -> ``weight``; the head count
  is not in the shapes, so ``dims`` is required).

``train_state_from_jax`` carries a JAX ``TrainState`` (adapter params,
optax Adam moments, counts, learning rate, step) across, so a JAX
checkpoint resumes in the port.

``load_biovil_npz`` reads a ``.npz`` bundle written by the JAX package's
``cli/convert_weights.py`` (``utils/serialization.py`` layout) with this
package's own reader.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Sequence

import numpy as np
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
    EXPANSION,
    Bottleneck,
    Conv2d,
    FrozenBatchNorm,
    ResNet50,
)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


@torch.no_grad()
def _set_conv(conv: Conv2d, p: Mapping[str, Any]) -> None:
    k = _t(p["kernel"]).permute(3, 2, 0, 1)  # HWIO -> OIHW
    if conv.weight.shape != k.shape:
        raise ValueError(f"conv kernel {tuple(k.shape)} does not fit {tuple(conv.weight.shape)}")
    conv.weight.copy_(k)


@torch.no_grad()
def _set_bn(bn: FrozenBatchNorm, p: Mapping[str, Any]) -> None:
    for name in ("scale", "bias", "mean", "var"):
        getattr(bn, name).copy_(_t(p[name]))


def _load_layer(layer, blocks: Sequence[Mapping[str, Any]]) -> None:
    for block, p in zip(layer, blocks, strict=True):
        for name in ("conv1", "conv2", "conv3"):
            _set_conv(getattr(block, name), p[name])
        for name in ("bn1", "bn2", "bn3"):
            _set_bn(getattr(block, name), p[name])
        if block.downsample_conv is not None:
            _set_conv(block.downsample_conv, p["downsample_conv"])
            _set_bn(block.downsample_bn, p["downsample_bn"])
        elif "downsample_conv" in p:
            raise ValueError("unexpected downsample in a block without one")


def layer_from_jax(blocks: Sequence[Mapping[str, Any]], cin: int, width: int,
                   stride: int = 1) -> nn.ModuleList:
    """One ResNet layer (a list of JAX bottleneck trees) -> ``nn.ModuleList``."""
    layer = nn.ModuleList(
        Bottleneck(cin if bi == 0 else width * EXPANSION, width, stride if bi == 0 else 1)
        for bi in range(len(blocks))
    )
    _load_layer(layer, blocks)
    return layer.eval()


def _resnet_from_jax(tree: Mapping[str, Any]) -> ResNet50:
    model = ResNet50(in_channels=np.shape(tree["conv1"]["kernel"])[2])  # 1 once grayscale-folded
    _set_conv(model.conv1, tree["conv1"])
    _set_bn(model.bn1, tree["bn1"])
    for li in range(1, 5):
        _load_layer(getattr(model, f"layer{li}"), tree[f"layer{li}"])
    return model.eval()


@torch.no_grad()
def _biovil_from_jax(tree: Mapping[str, Any]) -> BioViLImageModel:
    model = BioViLImageModel(_resnet_from_jax(tree["encoder"]))
    proj = tree["projector"]
    _set_conv(model.projector.conv1, proj["conv1"])
    _set_bn(model.projector.bn, proj["bn"])
    _set_conv(model.projector.conv2, proj["conv2"])
    model.projector.conv2_bias.copy_(_t(proj["conv2"]["bias"]))
    return model.eval()


@torch.no_grad()
def _dense_from_jax(layer: nn.Linear, p: Mapping[str, Any]) -> None:
    layer.weight.copy_(_t(p["kernel"]).T)
    layer.bias.copy_(_t(p["bias"]))


def _adapter_from_jax(p: Mapping[str, Any]) -> nn.Module:
    if "dense2" in p:
        hidden = np.shape(p["dense1"]["kernel"])[1]
        module = MLPAdapter(np.shape(p["dense1"]["kernel"])[0], hidden)
        _dense_from_jax(module.dense1, p["dense1"])
        _dense_from_jax(module.dense2, p["dense2"])
    else:
        module = LinearAdapter(np.shape(p["dense1"]["kernel"])[0])
        _dense_from_jax(module.dense1, p["dense1"])
    return module


@torch.no_grad()
def _ln_from_jax(ln: nn.LayerNorm, p: Mapping[str, Any]) -> None:
    ln.weight.copy_(_t(p["scale"]))
    ln.bias.copy_(_t(p["bias"]))


@torch.no_grad()
def _bert_from_jax(tree: Mapping[str, Any], dims) -> CXRBert:
    # any dims object with BertDims' fields (the JAX package's own included)
    dims = BertDims(**{f.name: getattr(dims, f.name) for f in dataclasses.fields(BertDims)})
    model = CXRBert(dims, projection="cls_projection" in tree)
    emb, p = model.embeddings, tree["embeddings"]
    for name in ("word", "position", "token_type"):
        getattr(emb, name).weight.copy_(_t(p[name]))
    _ln_from_jax(emb.ln, p["ln"])
    for layer, p in zip(model.layers, tree["layers"], strict=True):
        for name in ("q", "k", "v", "attn_out", "ffn_in", "ffn_out"):
            _dense_from_jax(getattr(layer, name), p[name])
        _ln_from_jax(layer.attn_ln, p["attn_ln"])
        _ln_from_jax(layer.ffn_ln, p["ffn_ln"])
    head, p = model.mlm_head, tree["mlm_head"]
    _dense_from_jax(head.transform_dense, p["transform_dense"])
    _ln_from_jax(head.transform_ln, p["transform_ln"])
    head.decoder_bias.copy_(_t(p["decoder_bias"]))
    if model.cls_projection is not None:
        proj, p = model.cls_projection, tree["cls_projection"]
        _dense_from_jax(proj.dense_to_hidden, p["dense_to_hidden"])
        _ln_from_jax(proj.ln, p["ln"])
        _dense_from_jax(proj.dense_to_output, p["dense_to_output"])
    return model


def params_from_jax(tree: Mapping[str, Any], dims: Optional[Any] = None):
    """A JAX parameter tree (numpy leaves) -> the port's module(s);
    ``dims`` (a ``BertDims``) for a CXR-BERT tree."""
    if "encoder" in tree and "projector" in tree:
        return _biovil_from_jax(tree)
    if "embeddings" in tree and "layers" in tree:
        if dims is None:
            raise ValueError("a CXR-BERT tree needs dims= (the head count is not in the shapes)")
        return _bert_from_jax(tree, dims)
    if set(tree) <= {"image", "text", "shared"}:
        return nn.ModuleDict({k: _adapter_from_jax(v) for k, v in tree.items()})
    raise ValueError(f"unrecognised parameter tree with keys {sorted(tree)}")


def load_biovil_npz(path: str) -> BioViLImageModel:
    """BioViL image model from a JAX ``.npz`` weight bundle."""
    from incremental_multimodal_medical_learning_ii_torch.utils.serialization import (
        load_params_npz,
    )

    tree, _ = load_params_npz(path)
    return params_from_jax(tree)


def adapter_params_from_jax(tree: Mapping[str, Any], device="cpu"):
    """An adapter tree (params, or an optimiser moment of the same layout)
    -> the port's parameter dict, ``kernel`` (in, out) -> ``weight`` (out, in)."""
    from incremental_multimodal_medical_learning_ii_torch.engine.steps import params_from_modules

    return params_from_modules(params_from_jax(tree), device) if tree else {}


def _opt_nodes(state):
    """Every namedtuple node of an optax state, depth first."""
    if hasattr(state, "_fields"):
        yield state
        for v in state:
            yield from _opt_nodes(v)
    elif isinstance(state, (tuple, list)):
        for v in state:
            yield from _opt_nodes(v)


def train_state_from_jax(state, lr: Optional[float] = None, device="cpu"):
    """A JAX ``TrainState`` (params, optax state, step; numpy leaves, e.g.
    ``jax.device_get`` of a checkpoint) -> the port's ``TrainState``.

    Adam's ``mu``/``nu`` come from the ``ScaleByAdamState`` and are
    transposed like the weights; ``count`` from it (else from the schedule's
    or ``inject_hyperparams``' counter); ``lr`` from ``inject_hyperparams``'
    ``learning_rate`` (a scheduled optimiser keeps no rate in its state:
    pass ``lr``)."""
    from incremental_multimodal_medical_learning_ii_torch.engine.steps import TrainState

    nodes = list(_opt_nodes(state.opt_state))
    adam = next((n for n in nodes if {"mu", "nu"} <= set(n._fields)), None)
    counted = [n for n in nodes if "count" in n._fields]
    hyper = next((n for n in nodes if "hyperparams" in n._fields), None)
    if hyper is not None and "learning_rate" in hyper.hyperparams:
        lr = float(np.asarray(hyper.hyperparams["learning_rate"]))
    if lr is None:
        raise ValueError("the optimiser state holds no learning rate: pass lr=")
    count = adam.count if adam is not None else counted[-1].count
    return TrainState(
        params=adapter_params_from_jax(state.params, device),
        mu=adapter_params_from_jax(adam.mu, device) if adam is not None else {},
        nu=adapter_params_from_jax(adam.nu, device) if adam is not None else {},
        count=torch.tensor(int(np.asarray(count)), dtype=torch.int32, device=device),
        lr=torch.tensor(lr, dtype=torch.float32, device=device),
        step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32, device=device),
    )
