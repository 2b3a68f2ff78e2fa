"""Port engine/steps.py: the train step and optimisers against the JAX
package (optax), the eval pass, ``guard_empty``, the JAX state carried
across, and the fused paths against the per-epoch path within the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incremental_multimodal_medical_learning_ii_tpu.engine import steps as js
from incremental_multimodal_medical_learning_ii_tpu.models.adapters import AdapterPair as JPair
from incremental_multimodal_medical_learning_ii_tpu.objectives.scorer import PromptBank as JBank
from incremental_multimodal_medical_learning_ii_tpu.utils.config import ExperimentConfig as JConfig
from incremental_multimodal_medical_learning_ii_torch.convert import (
    adapter_params_from_jax,
    train_state_from_jax,
)
from incremental_multimodal_medical_learning_ii_torch.data.store import synthetic_dataset
from incremental_multimodal_medical_learning_ii_torch.engine import protocols
from incremental_multimodal_medical_learning_ii_torch.engine import steps as ts
from incremental_multimodal_medical_learning_ii_torch.engine.protocols import (
    DataBundle,
    run_class_incremental,
    run_data_incremental,
    run_zero_joint,
)
from incremental_multimodal_medical_learning_ii_torch.engine.trainer import Trainer
from incremental_multimodal_medical_learning_ii_torch.models.adapters import AdapterPair as TPair
from incremental_multimodal_medical_learning_ii_torch.text.bank import (
    build_prompt_bank,
    synthetic_encode_fn,
)
from incremental_multimodal_medical_learning_ii_torch.text.prompts import create_prompts
from incremental_multimodal_medical_learning_ii_torch.utils.config import (
    CHEXPERT_COMPETITION_TASKS,
    ExperimentConfig,
)

from torch_port_helpers import assert_parity, one_torch_thread, to_numpy_tree  # noqa: F401

ADAM_ATOL = 2e-5  # the JAX package's Adam-dynamics bar (PARITY.md:81)
EVAL_ATOL = 1e-6


def _bank(train_logit_diff=True):
    return build_prompt_bank(
        synthetic_encode_fn(), create_prompts(CHEXPERT_COMPETITION_TASKS,
                                              train_logit_diff=train_logit_diff),
        CHEXPERT_COMPETITION_TASKS, train_logit_diff=train_logit_diff)


def _jbank(bank):
    return JBank(*(jnp.asarray(t.numpy()) for t in bank))


def _pairs(cfg_kw):
    jcfg, tcfg = JConfig(**cfg_kw), ExperimentConfig(**cfg_kw)
    wiring = dict(kind=tcfg.adapter, shared=tcfg.shared, use_image=tcfg.image_adapter,
                  use_text=tcfg.text_adapter)
    return jcfg, tcfg, JPair(**wiring), TPair(**wiring)


def _batches(rng, n, bs=32, pad=5):
    out = []
    for _ in range(n):
        embs = rng.normal(size=(bs, 128)).astype(np.float32)
        labels = (rng.random((bs, 5)) < 0.3).astype(np.float32)
        mask = np.ones(bs, np.float32)
        mask[bs - pad:] = 0.0  # a ragged final batch's padding
        out.append((embs, labels, mask))
    return out


def _jax_steps(jcfg, jpair, jstate, tx, jbank, batches, class_mask, threshold):
    step = js.build_train_step(jpair, tx, jcfg)
    metrics = []
    for embs, labels, mask in batches:
        jstate, m = step(jstate, jnp.asarray(embs), jnp.asarray(labels), jnp.asarray(mask),
                         jnp.asarray(class_mask), jbank, jnp.float32(threshold))
        metrics.append(jax.device_get(m))
    return jstate, metrics


def _port_steps(tcfg, tpair, tstate, tbank, batches, class_mask, threshold):
    step = ts.build_train_step(tpair, tcfg)
    metrics = []
    for embs, labels, mask in batches:
        tstate, m = step(tstate, torch.from_numpy(embs), torch.from_numpy(labels),
                         torch.from_numpy(mask), torch.from_numpy(class_mask), tbank,
                         torch.tensor(threshold, dtype=torch.float32))
        metrics.append({k: v.numpy() for k, v in m.items()})
    return tstate, metrics


def _compare_states(name, tstate, jstate, atol):
    jparams = adapter_params_from_jax(to_numpy_tree(jax.device_get(jstate.params)))
    for k in jparams:
        assert_parity(f"{name} {k}", tstate.params[k].numpy(), jparams[k].numpy(), atol)


STEP_CASES = {
    "adam": dict(),
    "sgd": dict(optim="sgd", lr=0.1),
    "adam-exponential": dict(lr_schedule="exponential", lr_gamma=0.9),
    "sgd-exponential": dict(optim="sgd", lr=0.1, lr_schedule="exponential", lr_gamma=0.9),
    "max-mycl-shared": dict(prompt_mode="max", continual_learning="myCL", shared=True,
                            max_gap_per_class=True),
    "dense-pos-change-labels": dict(adapter="dense", train_logit_diff=False, change_labels=True,
                                    prompt_mode="single", text_adapter=False),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_steps_match_jax(rng, case):
    kw = dict(lr=1e-3, batch_size=32, **{k: v for k, v in STEP_CASES[case].items() if k != "lr"})
    kw["lr"] = STEP_CASES[case].get("lr", 1e-3)
    jcfg, tcfg, jpair, tpair = _pairs(kw)
    jparams = jpair.init(jax.random.PRNGKey(5))
    jstate, tx = js.init_train_state(jpair, jparams, jcfg)
    tstate = ts.init_train_state(adapter_params_from_jax(to_numpy_tree(jparams)), tcfg, "cpu")
    bank = _bank(tcfg.train_logit_diff)
    class_mask = np.array([1, 1, 0, 1, 1], np.float32)
    batches = _batches(rng, 3)
    jstate, jm = _jax_steps(jcfg, jpair, jstate, tx, _jbank(bank), batches, class_mask, 0.05)
    tstate, tm = _port_steps(tcfg, tpair, tstate, bank, batches, class_mask, 0.05)
    assert [sorted(m) for m in tm] == [sorted(m) for m in jm]
    for i, (a, b) in enumerate(zip(tm, jm)):
        for k in b:
            if k.startswith("n_"):
                assert abs(int(a[k]) - int(b[k])) <= 2, (k, a[k], b[k])
            else:
                assert_parity(f"{case} step {i} {k}", a[k], np.asarray(b[k]), ADAM_ATOL)
    _compare_states(case, tstate, jstate, ADAM_ATOL)
    assert int(tstate.step) == int(jstate.step) == 3
    assert int(tstate.count) == 3


def test_guard_empty_is_a_bitwise_no_op(rng):
    tcfg = ExperimentConfig(lr=1e-3, batch_size=32, continual_learning="myCL")
    tpair = TPair("mlp", False, True, True)
    params = ts.params_from_modules(tpair.init(torch.Generator().manual_seed(0)), "cpu")
    bank = _bank()
    guarded = ts._train_core(tpair, tcfg, guard_empty=True)
    plain = ts._train_core(tpair, tcfg)
    state = ts.init_train_state(params, tcfg, "cpu")
    ones = torch.ones(5)
    (embs, labels, mask), = _batches(rng, 1)
    args = (torch.from_numpy(embs), torch.from_numpy(labels))
    state, _ = plain(state, *args, torch.from_numpy(mask), ones, bank, 0.01)  # nonzero moments
    after_empty, _ = guarded(state, *args, torch.zeros(32), ones, bank, torch.tensor(0.01))
    for field, a, b in zip(ts.TrainState._fields, after_empty, state):
        if isinstance(a, dict):
            assert all(torch.equal(a[k], b[k]) for k in a), field
        else:
            assert torch.equal(a, b), field
    # a real batch: the guard is the identity, bit for bit
    g, gm = guarded(state, *args, torch.from_numpy(mask), ones, bank, torch.tensor(0.01))
    p, pm = plain(state, *args, torch.from_numpy(mask), ones, bank, torch.tensor(0.01))
    assert all(torch.equal(g.params[k], p.params[k]) for k in p.params)
    assert all(torch.equal(gm[k], pm[k]) for k in pm)
    # and an unguarded zero-grad Adam step is not a no-op
    moved, _ = plain(state, *args, torch.zeros(32), ones, bank, torch.tensor(0.0))
    assert not all(torch.equal(moved.params[k], state.params[k]) for k in state.params)


@pytest.mark.parametrize("optim", ["adam", "sgd-exponential"])
def test_train_state_from_jax_continues_the_jax_run(rng, optim):
    kw = dict(lr=1e-3, batch_size=32) if optim == "adam" else dict(
        lr=0.1, batch_size=32, optim="sgd", lr_schedule="exponential", lr_gamma=0.9)
    jcfg, tcfg, jpair, tpair = _pairs(kw)
    bank = _bank()
    class_mask = np.ones(5, np.float32)
    batches = _batches(rng, 4)
    jstate0, tx = js.init_train_state(jpair, jpair.init(jax.random.PRNGKey(2)), jcfg)
    jstate_k, _ = _jax_steps(jcfg, jpair, jstate0, tx, _jbank(bank), batches[:2], class_mask, 0.0)
    host_k = jax.device_get(jstate_k)  # before the donating steps below
    jstate_km, _ = _jax_steps(jcfg, jpair, jstate_k, tx, _jbank(bank), batches[2:], class_mask, 0.0)
    tstate = train_state_from_jax(host_k, lr=tcfg.lr)
    assert int(tstate.count) == 2 and int(tstate.step) == 2
    assert float(tstate.lr) == np.float32(tcfg.lr)
    if optim == "adam":
        mu = adapter_params_from_jax(to_numpy_tree(host_k.opt_state.inner_state[0].mu))
        assert torch.equal(tstate.mu["image.dense1.weight"], mu["image.dense1.weight"])
    tstate, _ = _port_steps(tcfg, tpair, tstate, bank, batches[2:], class_mask, 0.0)
    _compare_states(f"k+m {optim}", tstate, jstate_km, ADAM_ATOL)


@pytest.mark.parametrize("mode", ["mean", "max"])
def test_fused_eval_matches_jax(rng, mode):
    kw = dict(prompt_mode=mode, eval_batch_size=64)
    jcfg, tcfg, jpair, tpair = _pairs(kw)
    jparams = jpair.init(jax.random.PRNGKey(4))
    bank = _bank()
    n = 192
    embs = rng.normal(size=(n, 128)).astype(np.float32)
    labels = (rng.random((n, 5)) < 0.3).astype(np.float32)
    valid = np.ones(n, np.float32)
    valid[150:] = 0.0
    jout = js.build_fused_eval(jpair, jcfg)(
        jparams, jnp.asarray(embs), jnp.asarray(labels), jnp.asarray(valid), _jbank(bank))
    tout = ts.build_fused_eval(tpair, tcfg)(
        adapter_params_from_jax(to_numpy_tree(jparams)), torch.from_numpy(embs),
        torch.from_numpy(labels), torch.from_numpy(valid), bank)
    for name, a, b in zip(("losses", "scores", "preds"), tout, jout):
        assert tuple(a.shape) == b.shape
        assert_parity(f"fused eval {mode} {name}", a.numpy(), np.asarray(b), EVAL_ATOL)


def test_epoch_permutation_orders():
    a = ts.epoch_permutation(28, 1, 90, 96).numpy()
    assert sorted(a[:90]) == list(range(90)) and list(a[90:]) == list(range(90, 96))
    assert np.array_equal(a, ts.epoch_permutation(28, 1, 90, 96).numpy())
    assert not np.array_equal(a, ts.epoch_permutation(28, 2, 90, 96).numpy())


# ----------------------------------------------------------------------
# Within the port: the fused paths equal the per-epoch path, bit for bit
# ----------------------------------------------------------------------
class _Recorder:
    log_dir = None
    enabled = True

    def __init__(self):
        self.scalars = []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, float(value), int(step)))

    def commit(self):
        pass

    def discard(self):
        pass

    def close(self):
        pass


def _bundle(n_train=150, n_eval=70):
    rng = np.random.default_rng(7)
    dirs = rng.normal(size=(5, 128)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    return DataBundle(train=synthetic_dataset(n_train, seed=1, class_directions=dirs),
                      val=synthetic_dataset(n_eval, seed=2, class_directions=dirs),
                      test=synthetic_dataset(n_eval, seed=3, class_directions=dirs))


def _run(runner, cfg_kwargs, monkeypatch, states):
    rec = _Recorder()
    monkeypatch.setattr(protocols, "_make_writer", lambda cfg, log_dir: rec)
    monkeypatch.setattr(protocols, "_save_unit",
                        lambda trainer, writer, completed, extra=None:
                        states.append({k: v.clone() for k, v in trainer.state.params.items()}))
    cfg = ExperimentConfig(plot_figures="off", **cfg_kwargs)
    results = runner(cfg, _bundle(), _bank(), log_dir=None, device="cpu")
    return rec.scalars, results["trainer"]


FUSED_CASES = {
    "joint-mycl": (run_zero_joint, dict(mode="joint", continual_learning="myCL")),
    "data-inc-mycl": (run_data_incremental, dict(mode="data-inc", parts=3,
                                                 continual_learning="myCL",
                                                 threshold_scheduling=True)),
    "data-inc-profcl": (run_data_incremental, dict(mode="data-inc", parts=3,
                                                   continual_learning="profCL", threshold=0.05)),
    "class-more-labels-max": (run_class_incremental, dict(mode="class-pos-neg", more_labels=True,
                                                          prompt_mode="max",
                                                          max_gap_per_class=True)),
    "class-pos-profcl-uneven": (run_class_incremental, dict(mode="class-pos",
                                                            continual_learning="profCL",
                                                            threshold=0.05)),
}


def _inject_orders(monkeypatch):
    """The per-batch path draws its orders from numpy's stream, the device
    paths from ``epoch_permutation``: compare them under injected orders."""
    orig = Trainer.__init__

    def init(self, *a, **k):
        orig(self, *a, **k)
        self.permutation_source = lambda epoch, n: np.random.default_rng(epoch).permutation(n)

    monkeypatch.setattr(Trainer, "__init__", init)


@pytest.mark.parametrize("case", list(FUSED_CASES))
def test_fused_paths_equal_the_per_epoch_path(monkeypatch, case):
    """Per-epoch vs fused unit/run with the trainer's own orders; per-batch
    vs per-epoch with injected orders: streams, final state, per-unit
    states and aux state bit for bit."""
    runner, kw = FUSED_CASES[case]
    kw = dict(kw, epochs=2, batch_size=32, eval_batch_size=32, lr=1e-3, shuffle_train=True)
    folds = []
    orig = Trainer.train_incremental_run
    monkeypatch.setattr(Trainer, "train_incremental_run",
                        lambda self, *a, **k: folds.append(1) or orig(self, *a, **k))

    def run(extra):
        states = []
        scalars, trainer = _run(runner, dict(kw, **extra), monkeypatch, states)
        return scalars, trainer, states

    pairs = [(run({}), run(dict(fused_unit=True)))]
    assert folds == ([] if runner is run_zero_joint else [1])
    _inject_orders(monkeypatch)
    pairs.append((run({}), run(dict(fused_epoch=False))))
    for i, ((ref_scalars, ref_trainer, ref_states), (scalars, trainer, states)) in enumerate(pairs):
        assert len(ref_scalars) > 0
        assert scalars == ref_scalars
        for name in ts.TrainState._fields:
            a, b = getattr(trainer.state, name), getattr(ref_trainer.state, name)
            if isinstance(a, dict):
                assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a), name
            else:
                assert torch.equal(a, b), name
        assert len(states) == len(ref_states)
        for sa, sb in zip(states, ref_states):
            assert all(torch.equal(sa[k], sb[k]) for k in sb)
        aux, ref_aux = trainer.aux_state(), ref_trainer.aux_state()
        if i == 1:  # the per-batch path draws no device orders (as in the JAX package)
            del aux["epoch_counter"], ref_aux["epoch_counter"]
        assert aux == ref_aux


@pytest.mark.parametrize("fused_epoch", [True, False])
def test_quick_auroc_is_the_eval_metric(fused_epoch):
    """The device rank-statistic AUROC equals the host metric set's
    trapezoid AUROC on the same eval pass."""
    from incremental_multimodal_medical_learning_ii_torch.evaluation.metrics import (
        per_class_metrics,
    )

    trainer = Trainer(ExperimentConfig(eval_batch_size=32, fused_epoch=fused_epoch), _bank(),
                      device="cpu")
    val = _bundle().val
    y_true, y_pred, y_score = trainer._eval_pass(val, 1, log_loss_prefix=None)
    assert_parity("quick_auroc", trainer.quick_auroc(val),
                  per_class_metrics(y_true, y_pred, y_score)["auroc"], EVAL_ATOL)


@pytest.mark.parametrize("case", ["data-inc-profcl", "class-more-labels-max"])
def test_unit_fold_equals_the_per_epoch_path(monkeypatch, case):
    """With the whole-run fold off, ``--fused-unit`` runs one call per unit
    (``train_unit``, its evals folded in): the same streams and state."""
    runner, kw = FUSED_CASES[case]
    kw = dict(kw, epochs=2, batch_size=32, eval_batch_size=32, lr=1e-3)
    monkeypatch.setattr(Trainer, "incremental_run_fusible", lambda self, units, eval_data: False)
    calls = []
    orig = Trainer.train_unit
    monkeypatch.setattr(Trainer, "train_unit",
                        lambda self, *a, **k: calls.append(1) or orig(self, *a, **k))
    ref_scalars, ref_trainer = _run(runner, kw, monkeypatch, [])
    scalars, trainer = _run(runner, dict(kw, fused_unit=True), monkeypatch, [])
    assert calls == [1] * (3 if case.startswith("data") else 5)
    assert scalars == ref_scalars and len(scalars) > 0
    for k, v in ref_trainer.state.params.items():
        assert torch.equal(trainer.state.params[k], v)
