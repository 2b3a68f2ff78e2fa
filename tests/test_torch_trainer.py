"""The port's three drivers (cli/ -> engine/protocols.py -> engine/trainer.py)
against the JAX package's, through their CLIs, at toy size: the same data
(``--data-dir``), the JAX init carried across by ``params_from_jax`` and
the same epoch orders injected through ``permutation_source``; then the
event streams, run names and final parameters compared.  Also resume."""

import glob
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from incremental_multimodal_medical_learning_ii_tpu.cli import class_incremental as j_cls
from incremental_multimodal_medical_learning_ii_tpu.cli import data_incremental as j_data
from incremental_multimodal_medical_learning_ii_tpu.cli import zero_joint_bounds as j_joint
from incremental_multimodal_medical_learning_ii_tpu.engine.trainer import Trainer as JTrainer
from incremental_multimodal_medical_learning_ii_tpu.models.adapters import AdapterPair as JPair
from incremental_multimodal_medical_learning_ii_torch.cli import class_incremental as t_cls
from incremental_multimodal_medical_learning_ii_torch.cli import data_incremental as t_data
from incremental_multimodal_medical_learning_ii_torch.cli import zero_joint_bounds as t_joint
from incremental_multimodal_medical_learning_ii_torch.convert import (
    adapter_params_from_jax,
    params_from_jax,
)
from incremental_multimodal_medical_learning_ii_torch.data.store import synthetic_dataset
from incremental_multimodal_medical_learning_ii_torch.engine import protocols as tprot
from incremental_multimodal_medical_learning_ii_torch.engine.trainer import Trainer as TTrainer
from incremental_multimodal_medical_learning_ii_torch.evaluation.tb import read_scalars
from incremental_multimodal_medical_learning_ii_torch.models.adapters import AdapterPair as TPair
from incremental_multimodal_medical_learning_ii_torch.text.bank import (
    build_prompt_bank,
    synthetic_encode_fn,
)
from incremental_multimodal_medical_learning_ii_torch.text.prompts import create_prompts
from incremental_multimodal_medical_learning_ii_torch.utils.config import (
    CHEXPERT_COMPETITION_TASKS,
    data_incremental_config,
)

from torch_port_helpers import assert_parity, one_torch_thread, to_numpy_tree  # noqa: F401

LOSS_ATOL = 1e-5
METRIC_ATOL = 1e-4
PARAM_ATOL = 2e-5  # Adam dynamics (PARITY.md:81)
RESET_SLACK = 2  # myCL reset counts (PARITY.md:184-185)
LOSS_TAGS = ("train/Loss", "val/Loss")
COUNT_TAGS = ("monitor-resets/resets", "monitor-resets/updates")


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("embeddings")
    rng = np.random.default_rng(11)
    dirs = rng.normal(size=(5, 128)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    for split, n, seed in (("train", 96, 1), ("val", 64, 2), ("test", 64, 3)):
        synthetic_dataset(n, seed=seed, class_directions=dirs).save(d / f"{split}.npz")
    return d


def _orders(epoch, n):
    return np.random.default_rng(1000 + epoch).permutation(n)


@pytest.fixture
def injected(monkeypatch):
    """Both trainers start from the JAX init and draw the same orders."""
    for cls in (JTrainer, TTrainer):
        orig = cls.__init__

        def init(self, *a, _orig=orig, **k):
            _orig(self, *a, **k)
            self.permutation_source = _orders

        monkeypatch.setattr(cls, "__init__", init)

    def port_init(self, generator=None):
        jpair = JPair(kind=self.kind, shared=self.shared, use_image=self.use_image,
                      use_text=self.use_text)
        return params_from_jax(to_numpy_tree(jpair.init(jax.random.PRNGKey(27))))

    monkeypatch.setattr(TPair, "init", port_init)


def _capture(monkeypatch, module, name):
    out = {}
    orig = getattr(module, name)

    def run(*a, **k):
        out.update(orig(*a, **k))
        return out

    monkeypatch.setattr(module, name, run)
    return out


def _event_streams(log_dir: Path):
    files = sorted(glob.glob(str(log_dir / "**" / "events.out.tfevents.*"), recursive=True))
    assert len(files) == 1, files
    streams = {}
    for tag, step, value in read_scalars(files[0]):
        streams.setdefault(tag, []).append((step, value))
    return os.path.relpath(os.path.dirname(files[0]), log_dir), streams


DRIVERS = {
    "joint": (j_joint, t_joint, "run_zero_joint", ["--epochs", "2"]),
    "data-inc-mycl": (j_data, t_data, "run_data_incremental",
                      ["--parts", "3", "--epochs", "2", "--continual-learning", "myCL"]),
    "data-inc-profcl-fused": (j_data, t_data, "run_data_incremental",
                              ["--parts", "3", "--epochs", "2", "--continual-learning", "profCL",
                               "--fused-unit"]),
    "class-more-labels-max-fused": (j_cls, t_cls, "run_class_incremental",
                                    ["--epochs", "2", "--max-emb", "--fused-unit"]),
    "class-pos-mycl": (j_cls, t_cls, "run_class_incremental",
                       ["--epochs", "2", "--mode", "class-pos", "--no-more-labels",
                        "--continual-learning", "myCL", "--threshold-scheduling"]),
}


@pytest.mark.parametrize("driver", list(DRIVERS))
def test_driver_matches_jax_cli(tmp_path, monkeypatch, data_dir, injected, driver):
    jmod, tmod, runner, flags = DRIVERS[driver]
    # lr 1e-4 (the drivers' default): a weight whose reset flips on fp32
    # noise moves by at most the cutoff, min + t * (max - min) of ~lr steps
    common = ["--data-dir", str(data_dir), "--batch-size", "32", "--plot-figures", "off", *flags]
    jres = _capture(monkeypatch, jmod, runner)
    jmod.main([*common, "--log-dir", str(tmp_path / "jax"), "--mesh-devices", "1"])
    tres = tmod.main([*common, "--log-dir", str(tmp_path / "port"), "--device", "cpu"])
    jname, jstreams = _event_streams(tmp_path / "jax")
    tname, tstreams = _event_streams(tmp_path / "port")
    assert tname == jname
    assert sorted(tstreams) == sorted(jstreams)
    assert len(jstreams["train/Loss"]) > 0
    for tag, ref in jstreams.items():
        got = tstreams[tag]
        assert [s for s, _ in got] == [s for s, _ in ref], tag
        a, b = np.array([v for _, v in got]), np.array([v for _, v in ref])
        if tag in COUNT_TAGS:
            assert np.abs(a - b).max() <= RESET_SLACK, tag
        else:
            assert_parity(f"{driver} {tag}", a, b,
                          LOSS_ATOL if tag in LOSS_TAGS else METRIC_ATOL)
    jparams = adapter_params_from_jax(to_numpy_tree(jax.device_get(jres["trainer"].state.params)))
    tparams = tres["trainer"].state.params
    assert tparams.keys() == jparams.keys()
    for k in jparams:
        assert_parity(f"{driver} final {k}", tparams[k].numpy(), jparams[k].numpy(), PARAM_ATOL)


def _bundle():
    rng = np.random.default_rng(5)
    dirs = rng.normal(size=(5, 128)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    return tprot.DataBundle(train=synthetic_dataset(150, seed=1, class_directions=dirs),
                            val=synthetic_dataset(64, seed=2, class_directions=dirs),
                            test=synthetic_dataset(64, seed=3, class_directions=dirs))


def _merged_streams(run_dir: Path):
    streams = {}
    for f in sorted(run_dir.glob("events.out.tfevents.*")):
        for tag, step, value in read_scalars(f):
            streams.setdefault(tag, []).append((step, value))
    return {tag: sorted(v) for tag, v in streams.items()}


@pytest.mark.parametrize("fused_unit", [False, True], ids=["per-epoch", "fused"])
def test_resume_after_unit_two_equals_an_uninterrupted_run(tmp_path, monkeypatch, fused_unit):
    cfg = data_incremental_config(batch_size=32, eval_batch_size=32, epochs=2, parts=3, lr=1e-3,
                                  continual_learning="myCL", threshold=0.05, adder=0.01,
                                  fused_unit=fused_unit, plot_figures="off")
    bank = build_prompt_bank(synthetic_encode_fn(), create_prompts(CHEXPERT_COMPETITION_TASKS),
                             CHEXPERT_COMPETITION_TASKS)
    bundle = _bundle()
    full = tprot.run_data_incremental(cfg, bundle, bank, log_dir=str(tmp_path / "full"), device="cpu")

    class Boom:
        def __len__(self):
            return 50

        def __getattr__(self, name):
            raise RuntimeError("boom")

    orig_split = tprot.split_contiguous

    def broken_split(ds, parts):
        out = orig_split(ds, parts)
        out[2] = Boom()
        return out

    monkeypatch.setattr(tprot, "split_contiguous", broken_split)
    with pytest.raises(RuntimeError, match="boom"):
        tprot.run_data_incremental(cfg, bundle, bank, log_dir=str(tmp_path / "resumed"), device="cpu")
    monkeypatch.setattr(tprot, "split_contiguous", orig_split)
    run_dir = tmp_path / "resumed" / cfg.run_name()
    assert tprot.load_progress(run_dir) == 2
    resumed = tprot.run_data_incremental(cfg, bundle, bank, log_dir=str(tmp_path / "resumed"),
                                         device="cpu", resume=True)
    assert _merged_streams(run_dir) == _merged_streams(tmp_path / "full" / cfg.run_name())
    for k, v in full["trainer"].state.params.items():
        assert torch.equal(resumed["trainer"].state.params[k], v)
    assert sorted(p.name for p in run_dir.glob("train_state*")) == ["train_state", "train_state_unit3"]
