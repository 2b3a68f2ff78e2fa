"""The serving CLIs' ``--adapter-checkpoint``: a toy JAX training run (the
JAX package's ``zero_joint_bounds`` CLI, an orbax checkpoint), its state converted with
``convert.py::train_state_from_jax`` and saved with the port's
``save_checkpoint``; then the port's classify CLI serving the converted
checkpoint against the JAX classify CLI serving the JAX one, on the same
BioViL checkpoint file and synthetic prompt bank.  Also the optimiser
retry and the refusal of a missing checkpoint."""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incremental_multimodal_medical_learning_ii_tpu.cli import classify as jclassify
from incremental_multimodal_medical_learning_ii_tpu.cli import zero_joint_bounds as j_joint
from incremental_multimodal_medical_learning_ii_tpu.engine.checkpoint import (
    restore_checkpoint as j_restore,
)
from incremental_multimodal_medical_learning_ii_tpu.engine.steps import (
    init_train_state as j_init_state,
)
from incremental_multimodal_medical_learning_ii_tpu.inference import (
    ChexpertClassifier as JaxClassifier,
)
from incremental_multimodal_medical_learning_ii_tpu.models.adapters import AdapterPair as JPair
from incremental_multimodal_medical_learning_ii_tpu.utils.config import joint_config
from incremental_multimodal_medical_learning_ii_torch.cli import classify
from incremental_multimodal_medical_learning_ii_torch.cli import serve
from incremental_multimodal_medical_learning_ii_torch.convert import train_state_from_jax
from incremental_multimodal_medical_learning_ii_torch.data.store import synthetic_dataset
from incremental_multimodal_medical_learning_ii_torch.engine.checkpoint import save_checkpoint
from incremental_multimodal_medical_learning_ii_torch.inference import ChexpertClassifier

from torch_biovil_fixture import TorchBioViLImage, randomize_bn_stats
from torch_port_helpers import assert_parity

SCORE_ATOL = 1e-4  # the classifier bar (tests/test_torch_classifier.py)
SERVE = ["--size", "64", "--pad-to", "128", "--batch-size", "2"]
KW = dict(batch_size=2, size=64, pad_to=128)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(BioViL checkpoint, the JAX run dir, the port's converted run dir)."""
    d = tmp_path_factory.mktemp("adapter_ckpt")
    rng = np.random.default_rng(11)
    dirs = rng.normal(size=(5, 128)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    for split, n, seed in (("train", 96, 1), ("val", 32, 2), ("test", 32, 3)):
        synthetic_dataset(n, seed=seed, class_directions=dirs).save(d / f"{split}.npz")
    # a toy joint run: 1 epoch of 3 Adam steps, lr 1e-3 so the adapters move
    j_joint.main(["--data-dir", str(d), "--epochs", "1", "--batch-size", "32", "--lr", "1e-3",
                  "--plot-figures", "off", "--log-dir", str(d / "jax"), "--mesh-devices", "1"])
    (jax_run,) = [p.parent for p in (d / "jax").rglob("train_state")]
    cfg = joint_config(lr=1e-3)
    pair = JPair(cfg.adapter, cfg.shared, cfg.image_adapter, cfg.text_adapter)
    template, _ = j_init_state(pair, pair.init(jax.random.PRNGKey(0)), cfg)
    jstate = j_restore(jax_run, template)
    assert int(np.asarray(jstate.step)) == 3
    port_run = d / "port"
    save_checkpoint(port_run, train_state_from_jax(jstate, lr=cfg.lr))
    torch.manual_seed(0)
    biovil = TorchBioViLImage().eval()
    randomize_bn_stats(biovil, seed=2)
    torch.save(biovil.state_dict(), d / "biovil.pt")
    return d / "biovil.pt", jax_run, port_run


def _port_classifier(flags):
    p = argparse.ArgumentParser()
    classify.add_classifier_args(p)
    return classify.build_classifier(p.parse_args([*flags, "--device", "cpu"]))


def test_adapter_checkpoint_serves_the_jax_run(runs, rng):
    """Both CLIs restore the run's adapters; in fp32, from the pieces each
    CLI built, their scores agree to 1e-4 (the CLIs serve in bf16)."""
    biovil, jax_run, port_run = runs
    jp = argparse.ArgumentParser()
    jclassify.add_classifier_args(jp)
    jclf = jclassify.build_classifier(jp.parse_args(
        ["--biovil-checkpoint", str(biovil), "--adapter-checkpoint", str(jax_run), *SERVE]))
    tclf = _port_classifier(["--biovil-checkpoint", str(biovil),
                             "--adapter-checkpoint", str(port_run), *SERVE])
    assert (tclf.cfg.image_adapter, tclf.cfg.text_adapter, tclf.cfg.prompt_mode.value) == (
        jclf.cfg.image_adapter, jclf.cfg.text_adapter, jclf.cfg.prompt_mode.value)
    images = [(rng.random(s) * 255).astype(np.uint8) for s in ((100, 80), (80, 100), (70, 60))]
    jfp32 = JaxClassifier(jclf.image_params, jclf.bank, cfg=jclf.cfg,
                          adapter_params=jclf.adapter_params, dtype=jnp.float32, **KW)
    tfp32 = ChexpertClassifier(tclf.image_params, tclf.bank, cfg=tclf.cfg,
                               adapter_params=tclf.adapter_params, dtype=torch.float32,
                               device="cpu", **KW)
    assert_parity("classify CLI --adapter-checkpoint scores", tfp32.predict_arrays(images)[0],
                  np.asarray(jfp32.predict_arrays(images)[0]), SCORE_ATOL)


def test_wrong_optimiser_restores_through_the_retry(runs, capsys):
    biovil, _, port_run = runs
    flags = ["--biovil-checkpoint", str(biovil), "--adapter-checkpoint", str(port_run), *SERVE]
    adam = _port_classifier(flags)
    sgd = _port_classifier([*flags, "--optim", "sgd"])
    assert "restored with an adam optimiser-state template" in capsys.readouterr().out
    a, s = adam.adapter_params.state_dict(), sgd.adapter_params.state_dict()
    assert a.keys() == s.keys() and all(torch.equal(a[k], s[k]) for k in a)
    # an adapter layout the run did not train does not fit either template
    with pytest.raises(ValueError, match="params does not fit"):
        _port_classifier([*flags, "--adapter", "dense"])


def test_missing_checkpoint_raises_the_first_error(runs, tmp_path):
    biovil, _, _ = runs
    with pytest.raises(FileNotFoundError, match="train_state") as err:
        _port_classifier(["--biovil-checkpoint", str(biovil),
                          "--adapter-checkpoint", str(tmp_path), *SERVE])
    assert err.value.__suppress_context__  # re-raised as it was, not chained to the retry's
    # the HTTP server takes the same flags and restores the same way
    with pytest.raises(FileNotFoundError, match="train_state"):
        serve.main(["--biovil-checkpoint", str(biovil), "--adapter-checkpoint", str(tmp_path),
                    "--optim", "sgd", "--shared", "--no-text-adapter", "--adapter", "dense",
                    "--device", "cpu", *SERVE])
