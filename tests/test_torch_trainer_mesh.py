"""The port's data-parallel training (``parallel/mesh.py``, ``engine/``) at
two gloo ranks against the JAX package's on ``create_mesh(2)`` (the CPU
mesh of conftest.py), through the protocols at toy size: the same data,
the JAX init carried across and the same epoch orders injected.  Covered:
the per-batch path, the fused epoch with myCL, the eval-folded fused unit
(as tests/test_fused_mesh.py), the whole-run fold with myCL and its
per-unit counterpart bit for bit (as tests/test_fused_run.py), MORE_LABELS
in MAX mode; every case on 97 train rows, so the last batch of an epoch
leaves the second rank all padding.  The ranks' parameters must be
bit-equal and their streams equal."""

import jax
import numpy as np
import pytest

from incremental_multimodal_medical_learning_ii_tpu.data.store import EmbeddingDataset as JData
from incremental_multimodal_medical_learning_ii_tpu.engine import protocols as jprot
from incremental_multimodal_medical_learning_ii_tpu.engine.trainer import Trainer as JTrainer
from incremental_multimodal_medical_learning_ii_tpu.models.adapters import AdapterPair as JPair
from incremental_multimodal_medical_learning_ii_tpu.parallel.mesh import create_mesh as j_mesh
from incremental_multimodal_medical_learning_ii_tpu.text.bank import (
    build_prompt_bank,
    synthetic_encode_fn,
)
from incremental_multimodal_medical_learning_ii_tpu.text.prompts import create_prompts
from incremental_multimodal_medical_learning_ii_tpu.utils.config import (
    CHEXPERT_COMPETITION_TASKS,
    ExperimentConfig,
)
from incremental_multimodal_medical_learning_ii_torch.convert import adapter_params_from_jax
from incremental_multimodal_medical_learning_ii_torch.parallel.mesh import spawn_ranks

from torch_port_helpers import (  # noqa: F401
    Recorder,
    assert_parity,
    mesh_orders,
    mesh_splits,
    one_torch_thread,
    protocols_on_rank,
    to_numpy_tree,
)

LOSS_ATOL = 1e-5
METRIC_ATOL = 1e-4
PARAM_ATOL = 2e-5  # Adam dynamics (PARITY.md:81)
RESET_SLACK = 2  # myCL reset counts (PARITY.md:184-185)
LOSS_TAGS = ("train/Loss", "val/Loss")
COUNT_TAGS = ("monitor-resets/resets", "monitor-resets/updates")

BASE = dict(batch_size=32, eval_batch_size=32, plot_figures="off")
# lr 1e-4 where myCL runs: a weight whose reset flips on fp32 noise then
# moves by at most the cutoff (tests/test_torch_trainer.py)
CASES = {
    "per-batch joint": ("run_zero_joint",
                        dict(BASE, mode="joint", epochs=2, lr=1e-3, fused_epoch=False), True),
    "fused-epoch joint myCL": ("run_zero_joint",
                               dict(BASE, mode="joint", epochs=2, lr=1e-4,
                                    continual_learning="myCL"), True),
    "fused-unit data-inc": ("run_data_incremental",
                            dict(BASE, mode="data-inc", parts=3, epochs=2, lr=1e-3,
                                 fused_unit=True), False),
    "whole-run data-inc myCL": ("run_data_incremental",
                                dict(BASE, mode="data-inc", parts=3, epochs=2, lr=1e-4,
                                     fused_unit=True, continual_learning="myCL",
                                     threshold_scheduling=True), True),
    "class MORE_LABELS MAX fused": ("run_class_incremental",
                                    dict(BASE, mode="class-pos-neg", more_labels=True,
                                         prompt_mode="max", epochs=2, lr=1e-3,
                                         fused_unit=True), True),
}
# the whole-run fold against the per-unit mesh path, port only, bit for bit
PER_UNIT = ("per-unit data-inc myCL", "whole-run data-inc myCL")


def _jax_tree(kw):
    cfg = ExperimentConfig(**kw)
    pair = JPair(kind=cfg.adapter, shared=cfg.shared, use_image=cfg.image_adapter,
                 use_text=cfg.text_adapter)
    return to_numpy_tree(pair.init(jax.random.PRNGKey(cfg.seed)))


@pytest.fixture(scope="module")
def port_ranks():
    """Every case on two gloo ranks, in one group: [rank 0, rank 1]."""
    cases = dict(CASES)
    runner, kw, _ = CASES[PER_UNIT[1]]
    cases[PER_UNIT[0]] = (runner, kw, False)
    trees = {name: _jax_tree(kw) for name, (_, kw, _) in cases.items()}
    return spawn_ranks(protocols_on_rank, 2, "cpu", cases, trees, mesh_splits())


@pytest.fixture(scope="module")
def jax_bank():
    return build_prompt_bank(synthetic_encode_fn(), create_prompts(CHEXPERT_COMPETITION_TASKS),
                             CHEXPERT_COMPETITION_TASKS)


def _jax_run(name, bank, monkeypatch):
    runner, kw, fold = CASES[name]
    rec = Recorder()
    init = JTrainer.__init__

    def trainer_init(self, *a, **k):
        init(self, *a, **k)
        self.permutation_source = mesh_orders

    monkeypatch.setattr(JTrainer, "__init__", trainer_init)
    if not fold:
        monkeypatch.setattr(JTrainer, "incremental_run_fusible", lambda self, *a: False)
    monkeypatch.setattr(jprot, "_make_writer", lambda cfg, log_dir: rec)
    bundle = jprot.DataBundle(*(JData(e, lbl) for e, lbl in mesh_splits()))
    res = getattr(jprot, runner)(ExperimentConfig(**kw), bundle, bank, log_dir=None,
                                 mesh=j_mesh(2))
    params = adapter_params_from_jax(to_numpy_tree(jax.device_get(res["trainer"].state.params)))
    return rec.scalars, {k: v.numpy() for k, v in params.items()}


def _streams(scalars):
    out = {}
    for tag, value, step in scalars:
        out.setdefault(tag, []).append((step, value))
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_two_ranks_match_the_jax_mesh(port_ranks, jax_bank, monkeypatch, name):
    rank0, rank1 = (r[name] for r in port_ranks)
    # the ranks agree bit for bit: the same all-reduced updates everywhere
    assert rank0["scalars"] == rank1["scalars"]
    for k, v in rank0["params"].items():
        np.testing.assert_array_equal(v, rank1["params"][k], err_msg=k)
    jscalars, jparams = _jax_run(name, jax_bank, monkeypatch)
    ours, ref = _streams(rank0["scalars"]), _streams(jscalars)
    assert sorted(ours) == sorted(ref)
    assert len(ref["train/Loss"]) > 0
    for tag, want in ref.items():
        got = ours[tag]
        assert [s for s, _ in got] == [s for s, _ in want], tag
        a, b = np.array([v for _, v in got]), np.array([v for _, v in want])
        if tag in COUNT_TAGS:
            assert np.abs(a - b).max() <= RESET_SLACK, tag
        else:
            assert_parity(f"mesh {name} {tag}", a, b,
                          LOSS_ATOL if tag in LOSS_TAGS else METRIC_ATOL)
    assert rank0["params"].keys() == jparams.keys()
    for k in jparams:
        assert_parity(f"mesh {name} final {k}", rank0["params"][k], jparams[k], PARAM_ATOL)


def test_whole_run_fold_equals_the_per_unit_mesh_path(port_ranks):
    for rank in port_ranks:
        per_unit, fold = rank[PER_UNIT[0]], rank[PER_UNIT[1]]
        assert fold["scalars"] == per_unit["scalars"]
        for k, v in per_unit["params"].items():
            np.testing.assert_array_equal(fold["params"][k], v, err_msg=k)


def test_the_last_batch_leaves_rank_one_all_padding():
    """The data the cases run on: rank 1's half of every epoch's last
    32-row batch (one real row, padding at the tail) is all padding."""
    from incremental_multimodal_medical_learning_ii_torch.parallel.mesh import Mesh, shard_bounds

    (embs, _), _, _ = mesh_splits()
    n, bs = len(embs), BASE["batch_size"]
    assert n % bs == 1
    start, stop = shard_bounds(Mesh(rank=1, size=2, device=None, backend="gloo", group=None), bs)
    assert (n - n // bs * bs) <= start < stop
