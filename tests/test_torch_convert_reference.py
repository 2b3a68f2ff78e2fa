"""Port models/convert.py against the JAX package's: the reference's own
weight formats (a CXR-BERT state dict, an HF snapshot directory with
model.safetensors or pytorch_model.bin, the BioViL image checkpoint, the
pickled reference adapters) load into the same weights."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incremental_multimodal_medical_learning_ii_tpu.models import biovil_image as jbv
from incremental_multimodal_medical_learning_ii_tpu.models import convert as jconv
from incremental_multimodal_medical_learning_ii_torch.convert import params_from_jax
from incremental_multimodal_medical_learning_ii_torch.models import biovil_image as tbv
from incremental_multimodal_medical_learning_ii_torch.models import convert as tconv
from incremental_multimodal_medical_learning_ii_torch.text.tokenizer import write_test_vocab

from torch_biovil_fixture import TorchBioViLImage, randomize_bn_stats
from torch_port_helpers import assert_parity, reference_bert_state_dict

H, LAYERS, INTER, VOCAB, POS, PROJ = 64, 2, 96, 200, 40, 128


def _assert_same_model(model, jparams, jdims):
    """The port's converted model is exactly the JAX converter's tree."""
    assert dict(model.dims.__dict__) == dict(jdims.__dict__)
    ref = params_from_jax(jparams, jdims).state_dict()
    ours = model.state_dict()
    assert list(ours) == list(ref)
    for name in ours:
        assert torch.equal(ours[name], ref[name]), name


@pytest.mark.parametrize("variant", ["projection", "no-projection", "old-decoder-key", "heads"])
def test_cxr_bert_state_dict_converts_exactly(variant):
    sd = reference_bert_state_dict(projection=variant != "no-projection",
                                   decoder_bias="cls.predictions.bias" if variant ==
                                   "old-decoder-key" else "cls.predictions.decoder.bias")
    heads = 4 if variant == "heads" else None
    jparams, jdims = jconv.convert_cxr_bert_state_dict(sd, num_heads=heads)
    model = tconv.convert_cxr_bert_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                                              num_heads=heads)
    _assert_same_model(model, jparams, jdims)
    assert model.dims.num_heads == (4 if heads else 1)  # hidden 64: one head of 64
    assert (model.cls_projection is None) == (variant == "no-projection")


def test_checkpoint_file_and_shape_check(tmp_path):
    sd = {k: torch.from_numpy(v) for k, v in reference_bert_state_dict(1).items()}
    torch.save(sd, tmp_path / "cxr_bert.pt")
    jparams, jdims = jconv.load_cxr_bert_checkpoint(str(tmp_path / "cxr_bert.pt"))
    _assert_same_model(tconv.load_cxr_bert_checkpoint(str(tmp_path / "cxr_bert.pt")), jparams, jdims)
    sd["bert.encoder.layer.1.output.dense.bias"] = torch.zeros(H + 1)
    with pytest.raises(ValueError, match="does not fit"):
        tconv.convert_cxr_bert_state_dict(sd)


def _snapshot(directory, sd, weights, config_overrides=(), tok_cfg=None):
    directory.mkdir()
    cfg = dict(vocab_size=VOCAB, hidden_size=H, num_hidden_layers=LAYERS, num_attention_heads=2,
               intermediate_size=INTER, max_position_embeddings=POS, type_vocab_size=2,
               projection_size=PROJ)
    cfg.update(config_overrides)
    (directory / "config.json").write_text(json.dumps(cfg))
    if weights == "safetensors":
        from safetensors.numpy import save_file

        save_file(sd, str(directory / "model.safetensors"))
    elif weights == "bin":
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, directory / "pytorch_model.bin")
    write_test_vocab(directory / "vocab.txt")
    if tok_cfg is not None:
        (directory / "tokenizer_config.json").write_text(json.dumps(tok_cfg))
    return directory


@pytest.mark.parametrize("weights", ["safetensors", "bin"])
def test_snapshot_loads_exactly(tmp_path, weights):
    sd = reference_bert_state_dict(2)
    tok_cfg = {"do_lower_case": False, "mask_token": {"content": "[MASK]", "lstrip": False},
               "model_max_length": 512}
    d = _snapshot(tmp_path / "snap", sd, weights, tok_cfg=tok_cfg)
    jparams, jdims, jtok = jconv.load_cxr_bert_snapshot(d)
    model, tok = tconv.load_cxr_bert_snapshot(d)
    assert model.dims.num_heads == 2  # from config.json, not the head-width guess
    _assert_same_model(model, jparams, jdims)
    assert tok.do_lower_case is False and tok.max_allowed_input_length == POS
    prompts = ["Mild Cardiomegaly", "no EDEMA [MASK]"]
    for a, b in zip(tok.tokenize_prompts(prompts), jtok.tokenize_prompts(prompts)):
        np.testing.assert_array_equal(a, b)


def test_snapshot_rejects_lies_and_missing_weights(tmp_path):
    sd = reference_bert_state_dict(3)
    lying = _snapshot(tmp_path / "lying", sd, "bin", config_overrides={"num_hidden_layers": 3})
    with pytest.raises(ValueError, match="num_layers=3 but the weights imply 2"):
        tconv.load_cxr_bert_snapshot(lying)
    odd = _snapshot(tmp_path / "odd", sd, "bin", config_overrides={"num_attention_heads": 5})
    with pytest.raises(ValueError, match="not divisible"):
        tconv.load_cxr_bert_snapshot(odd)
    with pytest.raises(FileNotFoundError, match="no model.safetensors or pytorch_model.bin"):
        tconv.load_cxr_bert_snapshot(_snapshot(tmp_path / "empty", sd, None))
    bare = _snapshot(tmp_path / "bare", sd, "bin")
    (bare / "vocab.txt").unlink()
    assert tconv.load_cxr_bert_snapshot(bare)[1] is None


def test_safetensors_reader_dtypes(tmp_path):
    from safetensors.torch import load_file, save_file

    g = torch.Generator().manual_seed(0)
    tensors = {"f32": torch.randn(3, 5, generator=g), "f16": torch.randn(7, generator=g).half(),
               "bf16": torch.randn(2, 2, 3, generator=g).bfloat16(),
               "ids": torch.arange(6).reshape(1, 6), "empty": torch.zeros(0, 4)}
    save_file(tensors, str(tmp_path / "t.safetensors"), metadata={"format": "pt"})
    ours, ref = tconv.read_safetensors(tmp_path / "t.safetensors"), load_file(str(tmp_path / "t.safetensors"))
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype and torch.equal(ours[k], ref[k]), k


def test_biovil_image_checkpoint_forward_matches_jax(tmp_path):
    torch.manual_seed(0)
    ref_model = TorchBioViLImage().eval()
    randomize_bn_stats(ref_model, seed=1)
    torch.save(ref_model.state_dict(), tmp_path / "biovil.pt")
    jparams = jconv.load_biovil_image_checkpoint(str(tmp_path / "biovil.pt"))
    model = tconv.load_biovil_image_checkpoint(str(tmp_path / "biovil.pt"))
    x = np.random.default_rng(0).random((2, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        ours = tbv.biovil_image_forward(model, torch.from_numpy(x)).projected_global_embedding
        torch_ref, _ = ref_model(torch.from_numpy(x).permute(0, 3, 1, 2))
    jax_out = jbv.biovil_image_forward(jparams, jnp.asarray(x)).projected_global_embedding
    assert_parity("biovil checkpoint loader: global embedding vs jax loader", ours.numpy(),
                  np.asarray(jax_out), 2e-4)
    assert_parity("biovil checkpoint loader: global embedding vs the torch module", ours.numpy(),
                  torch_ref.numpy(), 2e-4)
    sd = ref_model.state_dict()
    del sd["encoder.encoder.layer1.0.conv3.weight"]
    with pytest.raises(ValueError, match="not a ResNet-50"):
        tconv.convert_biovil_image_state_dict(sd)


@pytest.mark.parametrize("cls_name", ["myMLP", "myLinearModel"])
def test_reference_adapter_loads_the_same_params(tmp_path, cls_name):
    import sys

    with tconv.reference_models_stub():
        cls = getattr(sys.modules["models"], cls_name)
        # the class path the reference's torch.save records: models.<name>
        cls.__module__, cls.__qualname__ = "models", cls_name
        module = cls()
        torch.save(module, tmp_path / "image_adapter.pt")
    assert "models" not in sys.modules  # the stub does not leak
    jparams = jconv.load_reference_adapter(str(tmp_path / "image_adapter.pt"))
    ours = tconv.load_reference_adapter(str(tmp_path / "image_adapter.pt"))
    ref = params_from_jax({"image": jparams})["image"]
    assert type(ours) is type(ref)
    for (name, a), (_, b) in zip(ours.state_dict().items(), ref.state_dict().items()):
        assert torch.equal(a, b), name
    x = torch.randn(3, 128)
    with torch.no_grad():
        torch.testing.assert_close(ours(x), module(x), rtol=0, atol=1e-6)
