"""Carry the JAX package's parameters into the port's modules.

``params_from_jax`` takes a parameter tree as the JAX package holds it,
with numpy (or array-like) leaves, and returns the port's counterpart:

* a BioViL image tree ``{"encoder": ..., "projector": ...}`` becomes a
  :class:`BioViLImageModel` (conv kernels HWIO -> OIHW; BN
  ``{scale, bias, mean, var}`` kept by name; the projector's conv2 bias);
  a space-to-depth stem's (4, 4, 4C, N) kernel becomes (N, 4C, 4, 4);
* a bare trunk tree ``{"conv1", "bn1", "layer1".."layer4"}`` becomes a
  :class:`ResNet50`, or a :class:`ResNet18` when its blocks have no
  ``conv3``;
* a multitask-head tree (``models/heads.py``: ``{"w", "b"}`` or the MLP's
  ``{"w1", "bn_*", "w2", "b2"}``) becomes a :class:`MultitaskHead`, its
  stacked arrays copied as they are;
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

``params_to_jax`` is the inverse (a port module -> a JAX-layout numpy
tree), so the port's ``cli/convert_weights.py`` writes bundles in the JAX
package's format.  ``load_biovil_npz`` reads a ``.npz`` bundle written by
either package's ``cli/convert_weights.py`` (``utils/serialization.py``
layout).
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
from incremental_multimodal_medical_learning_ii_torch.models.heads import (
    LINEAR_PARAMS,
    MLP_PARAMS,
    MultitaskHead,
)
from incremental_multimodal_medical_learning_ii_torch.models.resnet import (
    EXPANSION,
    Bottleneck,
    Conv2d,
    FrozenBatchNorm,
    ResNet18,
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
        for i in range(1, block.n_convs + 1):
            _set_conv(getattr(block, f"conv{i}"), p[f"conv{i}"])
            _set_bn(getattr(block, f"bn{i}"), p[f"bn{i}"])
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


def _resnet_from_jax(tree: Mapping[str, Any]):
    kh, _, cin, _ = np.shape(tree["conv1"]["kernel"])  # cin 1 once grayscale-folded
    if "conv3" in tree["layer1"][0]:
        model = ResNet50(in_channels=cin, stem_kernel=kh)  # kh 4: the space-to-depth stem
    else:
        model = ResNet18(in_channels=cin)
    _set_conv(model.conv1, tree["conv1"])
    _set_bn(model.bn1, tree["bn1"])
    for li in range(1, 5):
        _load_layer(getattr(model, f"layer{li}"), tree[f"layer{li}"])
    return model.eval()


@torch.no_grad()
def _biovil_from_jax(tree: Mapping[str, Any]) -> BioViLImageModel:
    encoder = _resnet_from_jax(tree["encoder"])
    if not isinstance(encoder, ResNet50):
        raise ValueError("a BioViL image model has a ResNet-50 trunk (its projector takes 2048 "
                         "features)")
    model = BioViLImageModel(encoder)
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


@torch.no_grad()
def _head_from_jax(tree: Mapping[str, Any]) -> MultitaskHead:
    if "w" in tree:
        t, d, c = np.shape(tree["w"])
        head = MultitaskHead(d, c, t)
    else:
        t, d, h = np.shape(tree["w1"])
        head = MultitaskHead(d, np.shape(tree["w2"])[2], t, hidden_dim=h)
    for name, value in tree.items():
        getattr(head, name).copy_(_t(value))
    return head.eval()


def params_from_jax(tree: Mapping[str, Any], dims: Optional[Any] = None):
    """A JAX parameter tree (numpy leaves) -> the port's module(s);
    ``dims`` (a ``BertDims``) for a CXR-BERT tree."""
    if "encoder" in tree and "projector" in tree:
        return _biovil_from_jax(tree)
    if "conv1" in tree and "layer4" in tree:
        return _resnet_from_jax(tree)
    if set(tree) in (set(LINEAR_PARAMS), set(MLP_PARAMS)):
        return _head_from_jax(tree)
    if "embeddings" in tree and "layers" in tree:
        if dims is None:
            raise ValueError("a CXR-BERT tree needs dims= (the head count is not in the shapes)")
        return _bert_from_jax(tree, dims)
    if set(tree) <= {"image", "text", "shared"}:
        return nn.ModuleDict({k: _adapter_from_jax(v) for k, v in tree.items()})
    raise ValueError(f"unrecognised parameter tree with keys {sorted(tree)}")


# ----------------------------------------------------------------------
# The inverse: the port's modules -> the JAX package's layout
# ----------------------------------------------------------------------
def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def _conv_to_jax(conv: nn.Module) -> dict:
    from incremental_multimodal_medical_learning_ii_torch.ops.quant import Int8Conv2d

    if isinstance(conv, Int8Conv2d):  # ops/quant.py's layout: kernel_q + w_scale
        return {"kernel_q": _np(conv.kernel_q).transpose(2, 3, 1, 0), "w_scale": _np(conv.w_scale)}
    return {"kernel": _np(conv.weight.to(torch.float32)).transpose(2, 3, 1, 0)}  # OIHW -> HWIO


def _bn_to_jax(bn: FrozenBatchNorm) -> dict:
    return {name: _np(getattr(bn, name)) for name in ("scale", "bias", "mean", "var")}


def _block_to_jax(block) -> dict:
    out = {}
    for i in range(1, block.n_convs + 1):
        out[f"conv{i}"] = _conv_to_jax(getattr(block, f"conv{i}"))
        out[f"bn{i}"] = _bn_to_jax(getattr(block, f"bn{i}"))
    if block.downsample_conv is not None:
        out["downsample_conv"] = _conv_to_jax(block.downsample_conv)
        out["downsample_bn"] = _bn_to_jax(block.downsample_bn)
    return out


def _resnet_to_jax(model) -> dict:
    out = {"conv1": _conv_to_jax(model.conv1), "bn1": _bn_to_jax(model.bn1)}
    for li in range(1, 5):
        out[f"layer{li}"] = [_block_to_jax(b) for b in getattr(model, f"layer{li}")]
    return out


def _dense_to_jax(layer: nn.Linear) -> dict:
    return {"kernel": _np(layer.weight).T.copy(), "bias": _np(layer.bias)}


def _ln_to_jax(ln: nn.LayerNorm) -> dict:
    return {"scale": _np(ln.weight), "bias": _np(ln.bias)}


def _adapter_to_jax(module: nn.Module) -> dict:
    out = {"dense1": _dense_to_jax(module.dense1)}
    if isinstance(module, MLPAdapter):
        out["dense2"] = _dense_to_jax(module.dense2)
    return out


def _bert_to_jax(model: CXRBert) -> dict:
    emb = model.embeddings
    out = {
        "embeddings": {**{n: _np(getattr(emb, n).weight) for n in ("word", "position", "token_type")},
                       "ln": _ln_to_jax(emb.ln)},
        "layers": [
            {**{n: _dense_to_jax(getattr(layer, n))
                for n in ("q", "k", "v", "attn_out", "ffn_in", "ffn_out")},
             "attn_ln": _ln_to_jax(layer.attn_ln), "ffn_ln": _ln_to_jax(layer.ffn_ln)}
            for layer in model.layers
        ],
        "mlm_head": {"transform_dense": _dense_to_jax(model.mlm_head.transform_dense),
                     "transform_ln": _ln_to_jax(model.mlm_head.transform_ln),
                     "decoder_bias": _np(model.mlm_head.decoder_bias)},
    }
    if model.cls_projection is not None:
        proj = model.cls_projection
        out["cls_projection"] = {"dense_to_hidden": _dense_to_jax(proj.dense_to_hidden),
                                 "ln": _ln_to_jax(proj.ln),
                                 "dense_to_output": _dense_to_jax(proj.dense_to_output)}
    return out


def params_to_jax(module: nn.Module):
    """The inverse of :func:`params_from_jax`: a port module -> the JAX
    package's parameter tree with numpy leaves (a :class:`BioViLImageModel`,
    a :class:`ResNet50` or :class:`ResNet18` trunk, a :class:`MultitaskHead`,
    a :class:`CXRBert`, one adapter or an ``nn.ModuleDict`` of adapters).
    ``save_params_npz`` of the result is the JAX package's bundle format."""
    if isinstance(module, BioViLImageModel):
        proj = module.projector
        conv2 = _conv_to_jax(proj.conv2)
        conv2["bias"] = _np(proj.conv2_bias)
        return {"encoder": _resnet_to_jax(module.encoder),
                "projector": {"conv1": _conv_to_jax(proj.conv1), "bn": _bn_to_jax(proj.bn),
                              "conv2": conv2}}
    if isinstance(module, (ResNet50, ResNet18)):
        return _resnet_to_jax(module)
    if isinstance(module, MultitaskHead):
        names = MLP_PARAMS if module.mlp else LINEAR_PARAMS
        return {name: _np(getattr(module, name)) for name in names}
    if isinstance(module, CXRBert):
        return _bert_to_jax(module)
    if isinstance(module, (MLPAdapter, LinearAdapter)):
        return _adapter_to_jax(module)
    if isinstance(module, nn.ModuleDict):
        return {k: _adapter_to_jax(v) for k, v in module.items()}
    raise ValueError(f"no JAX layout for {type(module).__name__}")


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
