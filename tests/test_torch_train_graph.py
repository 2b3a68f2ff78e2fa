"""Port engine/steps.py: a training epoch as a CUDA graph.

No CUDA here, so :class:`EagerGraph` stands in for ``steps.CudaGraph``: its
capture runs the body once and keeps the outputs, and each replay runs the
body again and writes the results into those outputs, as a graph's replay
overwrites its static outputs.  Against it: the static-buffer body equals
the eager epoch bit for bit; the selection rule; the fused drivers on the
graphed path equal the eager ones; nothing returned aliases a buffer; the
spans and counters."""

import collections
import types

import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_leaves

from incremental_multimodal_medical_learning_ii_torch.data.store import synthetic_dataset
from incremental_multimodal_medical_learning_ii_torch.engine import protocols
from incremental_multimodal_medical_learning_ii_torch.engine import steps as ts
from incremental_multimodal_medical_learning_ii_torch.engine.protocols import (
    DataBundle,
    run_class_incremental,
    run_data_incremental,
    run_zero_joint,
)
from incremental_multimodal_medical_learning_ii_torch.models.adapters import AdapterPair
from incremental_multimodal_medical_learning_ii_torch.text.bank import (
    build_prompt_bank,
    synthetic_encode_fn,
)
from incremental_multimodal_medical_learning_ii_torch.text.prompts import create_prompts
from incremental_multimodal_medical_learning_ii_torch.utils.config import (
    CHEXPERT_COMPETITION_TASKS,
    ExperimentConfig,
)
from incremental_multimodal_medical_learning_ii_torch.utils.profiling import recording

from torch_port_helpers import one_torch_thread  # noqa: F401

B = 32


class EagerGraph:
    """``steps.CudaGraph`` on the CPU (the module's docstring)."""

    def __init__(self, device=None):
        self.warmed = False

    def warm_up(self, fn):
        self.warmed = True
        fn()

    def capture(self, fn):
        self.fn = fn
        self.out = fn()
        return self.out

    def replay(self):
        for dst, src in zip(tree_leaves(self.out), tree_leaves(self.fn())):
            dst.copy_(src)


@pytest.fixture
def graphed(monkeypatch):
    """The graphed path on CPU operands: the rule without its device test,
    :class:`EagerGraph` for the capture; the ``EpochGraph``s made are kept."""
    made = []

    class Kept(ts.EpochGraph):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(ts, "_graphs_epoch", lambda mesh, embs: mesh is None and embs.shape[0] > 0)
    monkeypatch.setattr(ts, "CudaGraph", EagerGraph)
    monkeypatch.setattr(ts, "EpochGraph", Kept)
    return made


def _bank():
    return build_prompt_bank(synthetic_encode_fn(), create_prompts(CHEXPERT_COMPETITION_TASKS),
                             CHEXPERT_COMPETITION_TASKS)


def _equal(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


# ----------------------------------------------------------------------
# The static-buffer body against the eager epoch
# ----------------------------------------------------------------------
EPOCH_CASES = {  # name: (config, guard_empty, rows masked out of the last slab, epochs)
    "joint-mean": (dict(), False, 5, 1),
    "max-prompts": (dict(prompt_mode="max", max_gap_per_class=True), False, 5, 1),
    "mycl-thresholds": (dict(continual_learning="myCL"), False, 5, 1),
    "guard-empty-masked-slab": (dict(continual_learning="myCL"), True, B, 1),
    "unshuffled": (dict(shuffle_train=False), False, 5, 1),
    "two-epochs": (dict(continual_learning="myCL"), True, 5, 2),
}


def _epoch_inputs(cfg, masked: int, epochs: int):
    rng = np.random.default_rng(3)
    n_pad = 3 * B
    embs = torch.from_numpy(rng.normal(size=(n_pad, 128)).astype(np.float32))
    labels = torch.from_numpy((rng.random((n_pad, 5)) < 0.3).astype(np.float32))
    valid = torch.ones(n_pad)
    valid[n_pad - masked:] = 0.0  # the padding rows: a fully masked slab at masked = B
    class_mask = torch.tensor([1.0, 1.0, 0.0, 1.0, 1.0])
    n = n_pad - masked
    perms = torch.stack([torch.cat([torch.from_numpy(np.random.default_rng(e).permutation(n)),
                                    torch.arange(n, n_pad)]) for e in range(epochs)])
    if not cfg.shuffle_train:
        perms = perms[:, :0]
    thresholds = torch.tensor([0.02, 0.07][:epochs])
    return (embs, labels, valid, _bank(), class_mask), thresholds, perms


@pytest.mark.parametrize("case", list(EPOCH_CASES))
def test_static_body_equals_the_eager_epoch(case):
    """``EpochGraph.body`` on its buffers, run eagerly, equals
    ``_epoch_scan`` on the operands; so do replays through the same
    buffers, epoch after epoch, and the warm-up leaves the buffers as
    they were."""
    kw, guard, masked, epochs = EPOCH_CASES[case]
    cfg = ExperimentConfig(lr=1e-3, batch_size=B, **kw)
    pair = AdapterPair("mlp", False, True, True)
    core = ts._train_core(pair, cfg, guard_empty=guard)
    state0 = ts.init_train_state(
        ts.params_from_modules(pair.init(torch.Generator().manual_seed(0)), "cpu"), cfg, "cpu")
    unit, thresholds, perms = _epoch_inputs(cfg, masked, epochs)
    want, state = [], state0
    for e in range(epochs):
        state, metrics = ts._epoch_scan(core, cfg, state, *unit, thresholds[e], perms[e])
        want.append((state, metrics))
    if guard and masked == B:  # the masked slab trained nothing
        assert int(want[0][0].step) == 2 and int(want[0][0].count) == 2

    g = ts.EpochGraph(core, cfg, state0, *unit, thresholds[0], perms[0])
    assert _equal(g.body(), want[0])
    graph = EagerGraph()
    g.capture(graph)
    assert graph.warmed and _equal(g.state, state0)
    state = state0
    for e in range(epochs):
        got = g.replay(state, thresholds[e], perms[e])
        assert _equal(got, want[e]), e
        state = got[0]


# ----------------------------------------------------------------------
# Which calls take the graph
# ----------------------------------------------------------------------
@pytest.mark.parametrize("device, mesh, capturing, rows, graphs", [
    ("cuda", None, False, 6144, True),
    ("cpu", None, False, 6144, False),
    ("cuda", "mesh", False, 6144, False),
    ("cuda", None, True, 6144, False),
    ("cuda", None, False, 0, False),
])
def test_selection_rule(monkeypatch, device, mesh, capturing, rows, graphs):
    """The graph for CUDA operands with rows and no mesh, outside another
    capture; the eager loop otherwise (a stand-in tensor: no CUDA here)."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing)
    embs = types.SimpleNamespace(is_cuda=device == "cuda", shape=(rows, 128))
    mesh = object() if mesh else None
    assert ts._graphs_epoch(mesh, embs) is graphs


def test_cpu_operands_stay_eager():
    """The rule as shipped on CPU tensors: no capture, a span a step."""
    cfg = ExperimentConfig(mode="joint", epochs=2, batch_size=B, eval_batch_size=B,
                           fused_unit=True, plot_figures="off")
    with recording() as rec:
        run_zero_joint(cfg, _bundle(), _bank(), log_dir=None, device="cpu")
    names = collections.Counter(s.name for s in rec.spans)
    assert names["train-step"] == rec.counters["train_steps"] == 10
    assert "train_graph_captures" not in rec.counters and "train_graph_replays" not in rec.counters
    assert names["train-graph-capture"] == names["train-epoch-replay"] == 0


# ----------------------------------------------------------------------
# The fused drivers on the graphed path
# ----------------------------------------------------------------------
class _Writer:
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


DRIVER_CASES = {  # name: (runner, config, captures, replays)
    # 150 rows: 5 steps an epoch, 3 epochs
    "joint": (run_zero_joint, dict(mode="joint", continual_learning="myCL"), 1, 3),
    # one fused run: every part padded to the largest, one signature; 3 parts x 3 epochs
    "data-inc-mycl": (run_data_incremental, dict(mode="data-inc", parts=3,
                                                 continual_learning="myCL",
                                                 threshold_scheduling=True), 1, 9),
    # one fused run of 5 tasks, MAX prompts, profCL's eager reset between epochs
    "class-max-profcl": (run_class_incremental, dict(mode="class-pos-neg", more_labels=True,
                                                     prompt_mode="max", max_gap_per_class=True,
                                                     continual_learning="profCL",
                                                     threshold=0.05), 1, 15),
}


def _driver(runner, kw, monkeypatch):
    writer = _Writer()
    states = []
    monkeypatch.setattr(protocols, "_make_writer", lambda cfg, log_dir: writer)
    monkeypatch.setattr(protocols, "_save_unit",
                        lambda trainer, w, completed, extra=None:
                        states.append({k: v.clone() for k, v in trainer.state.params.items()}))
    cfg = ExperimentConfig(plot_figures="off", epochs=3, batch_size=B, eval_batch_size=B,
                           lr=1e-3, fused_unit=True, **kw)
    with recording() as rec:
        res = runner(cfg, _bundle(), _bank(), log_dir=None, device="cpu")
    return writer.scalars, res["trainer"], states, rec


@pytest.mark.parametrize("case", list(DRIVER_CASES))
def test_graphed_drivers_equal_the_eager_ones(monkeypatch, graphed, case):
    """A driver's fused calls on the graphed path log the same streams and
    end in the same states, bit for bit, as on the eager loop; a capture
    per signature, a replay an epoch, ``train_steps`` the steps trained,
    no ``train-step`` span."""
    runner, kw, captures, replays = DRIVER_CASES[case]
    rule = ts._graphs_epoch
    with monkeypatch.context() as eager:
        eager.setattr(ts, "_graphs_epoch", lambda mesh, embs: False)
        want_scalars, want_trainer, want_states, want_rec = _driver(runner, kw, monkeypatch)
    assert ts._graphs_epoch is rule
    scalars, trainer, states, rec = _driver(runner, kw, monkeypatch)
    assert len(scalars) > 0 and scalars == want_scalars
    assert _equal(trainer.state, want_trainer.state)
    assert len(states) == len(want_states) and all(_equal(a, b) for a, b in zip(states, want_states))
    assert trainer.aux_state() == want_trainer.aux_state()

    assert len(graphed) == captures
    names = collections.Counter(s.name for s in rec.spans)
    assert rec.counters["train_graph_captures"] == names["train-graph-capture"] == captures
    assert rec.counters["train_graph_replays"] == names["train-epoch-replay"] == replays
    assert rec.counters["train_steps"] == want_rec.counters["train_steps"]
    assert names["train-step"] == 0
    assert rec.counters["eval_batches"] == want_rec.counters["eval_batches"]
    by_id = {s.span_id: s for s in rec.spans}
    fused = {"fused-joint-run", "fused-incremental-run"}
    for name in ("train-graph-capture", "train-epoch-replay"):
        assert {by_id[s.parent_id].name for s in rec.named(name)} <= fused, name


def test_one_capture_per_signature(graphed):
    """A fused epoch callable captures once per signature of its operands
    and replays from the cache; other shapes capture their own graph."""
    cfg = ExperimentConfig(lr=1e-3, batch_size=B)
    pair = AdapterPair("mlp", False, True, True)
    epoch = ts.build_fused_epoch(pair, cfg)
    state = ts.init_train_state(
        ts.params_from_modules(pair.init(torch.Generator().manual_seed(0)), "cpu"), cfg, "cpu")
    with recording() as rec:
        for masked, rows in ((5, 3 * B), (7, 3 * B), (5, 2 * B)):
            (embs, labels, valid, bank, class_mask), thr, perms = _epoch_inputs(cfg, masked, 1)
            state, _ = epoch(state, embs[:rows], labels[:rows], valid[:rows], bank, class_mask,
                             thr[0], perms[0][perms[0] < rows])
    assert rec.counters["train_graph_captures"] == len(graphed) == 2
    assert rec.counters["train_graph_replays"] == 3
    assert rec.counters["train_steps"] == 3 + 3 + 2


def test_returned_tensors_do_not_alias_the_buffers(graphed):
    """Writing into every buffer of the graph after a fused unit call (the
    joint driver's, evals and epoch states folded in) leaves everything
    the call returned as it was."""
    cfg = ExperimentConfig(lr=1e-3, batch_size=B, eval_batch_size=B, continual_learning="myCL")
    pair = AdapterPair("mlp", False, True, True)
    unit = ts.build_fused_unit(pair, cfg, eval_mode="per_epoch")
    state = ts.init_train_state(
        ts.params_from_modules(pair.init(torch.Generator().manual_seed(0)), "cpu"), cfg, "cpu")
    (embs, labels, valid, bank, class_mask), thresholds, perms = _epoch_inputs(cfg, 5, 2)
    evals = (embs[:2 * B], labels[:2 * B], valid[:2 * B]) * 2
    out = unit(state, embs, labels, valid, bank, class_mask, thresholds, perms, *evals)
    kept = [t.clone() for t in tree_leaves(out)]
    (g,) = graphed
    for t in tree_leaves((g.state, g.unit, g.threshold, g.perm, g.outputs)):
        t.fill_(7)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(out), kept))
