"""Port utils/profiling.py (the JAX package's tests/test_profiling.py): a
trace is a Chrome trace file that holds the named spans, ``None`` traces
nothing, and the extraction and training paths put their spans in it.
The recorder: nothing is recorded or entered while nothing listens, spans
nest per thread, the garbage collector's collections are spans, and the
trainer, the protocol, the mesh and the extraction loop record their
spans and counters without changing what they compute."""

import collections
import contextlib
import gc
import threading

import numpy as np
import pytest
import torch

from incremental_multimodal_medical_learning_ii_torch.utils import profiling
from incremental_multimodal_medical_learning_ii_torch.utils.profiling import (
    annotate,
    count,
    maybe_trace,
    recording,
)

from torch_port_helpers import one_torch_thread, trace_spans  # noqa: F401


@pytest.mark.parametrize("recorded", [False, True])
def test_maybe_trace_writes_a_trace(tmp_path, recorded):
    """A span reaches the profiler's trace with or without a recorder."""
    with recording() if recorded else contextlib.nullcontext() as rec:
        with maybe_trace(str(tmp_path), device="cpu"):
            with annotate("smoke"):
                (torch.ones(64, 64) * 2).sum()
    assert trace_spans(tmp_path) == {"smoke": 1}
    if recorded:
        assert [s.name for s in rec.spans] == ["smoke"]


def test_nothing_listens(monkeypatch):
    """No recorder and no profiler: ``annotate`` enters no
    ``record_function`` and records nothing, ``count`` counts nothing."""
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: entered.append(name))
    with annotate("quiet", k=1) as span:
        span.drop()
    count("quiet_things")
    with recording() as rec:
        pass
    with annotate("after"):
        count("after_things")
    assert entered == [] and rec.spans == [] and rec.counters == {}
    assert annotate("a") is annotate("b")  # the one shared do-nothing context


def test_spans_nest_per_thread():
    def worker():
        with annotate("worker-outer"):
            with annotate("worker-inner", item=7):
                count("worker_items", 2)

    with recording() as rec:
        with annotate("outer"):
            with annotate("inner") as span:
                count("items")
                t = threading.Thread(target=worker)
                t.start()
                t.join(timeout=30)
            with annotate("dropped") as span:
                span.drop()
            with annotate("sibling"):
                pass
    assert not t.is_alive()
    s = {x.name: x for x in rec.spans}
    assert set(s) == {"outer", "inner", "sibling", "worker-outer", "worker-inner"}
    assert s["outer"].parent_id is None and s["worker-outer"].parent_id is None
    assert s["inner"].parent_id == s["outer"].span_id == s["sibling"].parent_id
    assert s["worker-inner"].parent_id == s["worker-outer"].span_id
    assert s["worker-inner"].attrs == {"item": 7}
    assert s["worker-outer"].thread_id != s["outer"].thread_id == threading.get_ident()
    assert len({x.span_id for x in rec.spans}) == 5
    for x in rec.spans:
        assert x.t0_ns <= x.t1_ns
    assert s["outer"].t0_ns <= s["inner"].t0_ns <= s["worker-inner"].t0_ns
    assert s["worker-inner"].t1_ns <= s["inner"].t1_ns <= s["outer"].t1_ns
    assert rec.counters == {"items": 1, "worker_items": 2}
    with pytest.raises(RuntimeError):
        with recording():
            with recording():
                pass


def test_garbage_collections_are_spans():
    hooks = list(gc.callbacks)
    with recording() as rec:
        with annotate("work"):
            gc.collect()
    assert gc.callbacks == hooks
    collections_ = rec.named("gc")
    assert collections_ and rec.counters.get("gc_collections_gen2", 0) >= 1
    full = [x for x in collections_ if x.attrs["generation"] == 2]
    assert full and full[-1].parent_id == rec.named("work")[0].span_id
    assert all(x.attrs["collected"] >= 0 for x in collections_)
    assert sum(rec.counters.get(f"gc_collections_gen{g}", 0) for g in range(3)) == len(collections_)


def test_maybe_trace_none_is_noop(tmp_path):
    with maybe_trace(None):
        with annotate("smoke"):
            pass
    assert not any(tmp_path.iterdir())


def test_extraction_trace_hook(tmp_path):
    """``extract_embeddings(trace_dir=)`` traces the run, each batch's
    dispatch and each window's readback in its span."""
    from incremental_multimodal_medical_learning_ii_torch.engine.extract import (
        extract_embeddings,
    )
    from incremental_multimodal_medical_learning_ii_torch.models.biovil_image import (
        init_biovil_image_model,
    )

    rng = np.random.default_rng(0)
    imgs = [((rng.random((70, 60)) * 255).astype(np.uint8), np.zeros(5, np.float32))
            for _ in range(4)]
    ds = extract_embeddings(iter(imgs), init_biovil_image_model(torch.Generator().manual_seed(0)),
                            batch_size=2, size=64, pad_to=128, dtype=torch.float32,
                            readback_interval=1, trace_dir=str(tmp_path / "trace"), device="cpu")
    assert len(ds) == 4
    spans = trace_spans(tmp_path / "trace")
    assert spans["extract_dispatch"] == 2 and spans["extract_readback"] >= 1


def test_train_protocol_trace_hook(tmp_path):
    """``run_zero_joint(trace_dir=)`` traces the train/eval loop: the fused
    epoch and both eval passes are spans of the trace."""
    from incremental_multimodal_medical_learning_ii_torch.data.store import synthetic_dataset
    from incremental_multimodal_medical_learning_ii_torch.engine.protocols import (
        DataBundle,
        run_zero_joint,
    )
    from incremental_multimodal_medical_learning_ii_torch.text.bank import (
        build_prompt_bank,
        synthetic_encode_fn,
    )
    from incremental_multimodal_medical_learning_ii_torch.text.prompts import template_prompts
    from incremental_multimodal_medical_learning_ii_torch.utils.config import (
        CHEXPERT_COMPETITION_TASKS,
        ExperimentConfig,
    )

    bundle = DataBundle(train=synthetic_dataset(96, seed=1), val=synthetic_dataset(64, seed=2),
                        test=synthetic_dataset(64, seed=3))
    bank = build_prompt_bank(synthetic_encode_fn(), template_prompts(CHEXPERT_COMPETITION_TASKS),
                             CHEXPERT_COMPETITION_TASKS)
    cfg = ExperimentConfig(mode="joint", epochs=1, batch_size=32, eval_batch_size=32,
                           plot_figures="off")
    run_zero_joint(cfg, bundle, bank, log_dir=None, device="cpu",
                   trace_dir=str(tmp_path / "trace"))
    spans = trace_spans(tmp_path / "trace")
    assert spans.get("eval-pass") == 2
    assert spans.get("fused-train-epoch", 0) + spans.get("fused-joint-run", 0) == 1


def _joint_inputs():
    from incremental_multimodal_medical_learning_ii_torch.data.store import synthetic_dataset
    from incremental_multimodal_medical_learning_ii_torch.engine.protocols import DataBundle
    from incremental_multimodal_medical_learning_ii_torch.text.bank import (
        build_prompt_bank,
        synthetic_encode_fn,
    )
    from incremental_multimodal_medical_learning_ii_torch.text.prompts import template_prompts
    from incremental_multimodal_medical_learning_ii_torch.utils.config import (
        CHEXPERT_COMPETITION_TASKS,
    )

    bundle = DataBundle(train=synthetic_dataset(100, seed=1), val=synthetic_dataset(70, seed=2),
                        test=synthetic_dataset(40, seed=3))
    bank = build_prompt_bank(synthetic_encode_fn(), template_prompts(CHEXPERT_COMPETITION_TASKS),
                             CHEXPERT_COMPETITION_TASKS)
    return bundle, bank


def test_joint_run_records_its_steps(tmp_path):
    """A fused joint run trains the same parameters, bit for bit, with the
    recorder on and off, and records one ``train-step`` a batch and one
    ``eval-batch`` an eval batch (4 x 3 epochs; (3 val + 2 test) x 3), the
    counters agreeing, every span of the run inside ``joint-run``."""
    from incremental_multimodal_medical_learning_ii_torch.engine.protocols import run_zero_joint
    from incremental_multimodal_medical_learning_ii_torch.utils.config import ExperimentConfig

    bundle, bank = _joint_inputs()
    cfg = ExperimentConfig(mode="joint", epochs=3, batch_size=32, eval_batch_size=32,
                           fused_unit=True, plot_figures="off")
    off = run_zero_joint(cfg, bundle, bank, log_dir=str(tmp_path / "off"), device="cpu")
    with recording() as rec:
        on = run_zero_joint(cfg, bundle, bank, log_dir=str(tmp_path / "on"), device="cpu")
    for k, v in off["trainer"].state.params.items():
        assert torch.equal(v, on["trainer"].state.params[k]), k
    names = collections.Counter(s.name for s in rec.spans)
    assert names["train-step"] == rec.counters["train_steps"] == 12
    assert names["eval-batch"] == rec.counters["eval_batches"] == 15
    assert names["readback"] == rec.counters["readbacks"] == 1  # the fused call's
    assert rec.counters["upload_bytes"] == sum(4 * rows * (128 + 5 + 1) for rows in (128, 96, 64))
    for name in ("joint-run", "trainer-init", "epoch-orders", "fused-joint-run", "save"):
        assert names[name] == 1, name
    assert names["upload"] == names["emit-epoch"] == names["train-logs"] == 3
    assert names["eval-metrics"] == 6 and names["tb-commit"] == 4  # each epoch's, the close's
    by_id = {s.span_id: s for s in rec.spans}
    run = rec.named("joint-run")[0]
    fused = rec.named("fused-joint-run")[0]
    for s in rec.spans:
        if s is not run and s.name != "gc":
            up = s
            while up.parent_id is not None:
                up = by_id[up.parent_id]
            assert up is run, s.name
    assert {by_id[s.parent_id].name for s in rec.named("train-step")} == {"fused-joint-run"}
    assert {by_id[s.parent_id].name for s in rec.named("eval-batch")} == {"fused-joint-run"}
    assert by_id[rec.named("readback")[0].parent_id] is fused
    assert {by_id[s.parent_id].name for s in rec.named("upload")} == {"joint-run"}


def test_extraction_prepares_in_its_thread():
    """One ``extract-prepare`` span a batch, in the prefetch thread; the
    upload and the encode apart inside each dispatch."""
    from incremental_multimodal_medical_learning_ii_torch.engine.extract import (
        extract_embeddings,
    )
    from incremental_multimodal_medical_learning_ii_torch.models.biovil_image import (
        init_biovil_image_model,
    )

    rng = np.random.default_rng(0)
    imgs = [((rng.random((70, 60)) * 255).astype(np.uint8), np.zeros(5, np.float32))
            for _ in range(5)]
    model = init_biovil_image_model(torch.Generator().manual_seed(0))
    with recording() as rec:
        ds = extract_embeddings(iter(imgs), model, batch_size=2, size=64, pad_to=128,
                                dtype=torch.float32, readback_interval=1, device="cpu")
    assert len(ds) == 5
    prepared = rec.named("extract-prepare")
    assert len(prepared) == rec.counters["prepared_batches"] == 3
    assert {s.thread_id for s in prepared} != {threading.get_ident()}
    assert all(s.parent_id is None for s in prepared)
    by_id = {s.span_id: s for s in rec.spans}
    for name in ("extract-upload", "extract-encode"):
        assert [by_id[s.parent_id].name for s in rec.named(name)] == ["extract_dispatch"] * 3


def test_two_ranks_record_their_steps():
    """On two gloo ranks each rank records its own ``train-step`` spans, one
    a step (4 batches x 2 epochs), on the host's one clock."""
    from incremental_multimodal_medical_learning_ii_torch.parallel.mesh import spawn_ranks

    from torch_port_helpers import mesh_splits, recorded_joint_on_rank

    kw = dict(mode="joint", epochs=2, batch_size=32, eval_batch_size=32, fused_unit=True,
              plot_figures="off")
    ranks = spawn_ranks(recorded_joint_on_rank, 2, "cpu", mesh_splits(), kw)
    assert [r["rank"] for r in ranks] == [0, 1]
    for r in ranks:
        assert len(r["steps"]) == r["counters"]["train_steps"] == 8
        assert all(name == "train-step" and t0 <= t1 for name, t0, t1 in r["steps"])
    # gloo's all_reduce holds each rank's k-th step until the other's has
    # begun, so on one clock the ranks' k-th steps overlap
    for a, b in zip(ranks[0]["steps"], ranks[1]["steps"]):
        assert a[2] >= b[1] and b[2] >= a[1]
