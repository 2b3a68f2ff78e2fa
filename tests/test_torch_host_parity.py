"""The port's host-side helpers against the JAX package's, on the CPU:
``retry_call``, the zero-shot and class-incremental config factories, the
progress file of a resumable run (written by one package, read by the
other), the compositional prompt candidates and the t-SNE / task subsets
of the embedding store. Each is a copy of its JAX counterpart at the same
path, so the two must agree exactly."""

import dataclasses
import enum
import types

import numpy as np
import pytest

from incremental_multimodal_medical_learning_ii_torch.data import store as tstore
from incremental_multimodal_medical_learning_ii_torch.engine import checkpoint as tckpt
from incremental_multimodal_medical_learning_ii_torch.text import prompts as tprompts
from incremental_multimodal_medical_learning_ii_torch.utils import config as tconfig
from incremental_multimodal_medical_learning_ii_torch.utils import retry as tretry
from incremental_multimodal_medical_learning_ii_tpu.data import store as jstore
from incremental_multimodal_medical_learning_ii_tpu.engine import checkpoint as jckpt
from incremental_multimodal_medical_learning_ii_tpu.text import prompts as jprompts
from incremental_multimodal_medical_learning_ii_tpu.utils import config as jconfig
from incremental_multimodal_medical_learning_ii_tpu.utils import retry as jretry


def _retry_trace(module, monkeypatch, retries, failures):
    """Run ``module.retry_call`` on a function that raises ``failures``
    times before it returns; what it returned or raised, the ``on_retry``
    attempts and the sleeps."""
    sleeps, seen, calls = [], [], []
    monkeypatch.setattr(module, "time", types.SimpleNamespace(sleep=sleeps.append))

    def fn():
        calls.append(None)
        if len(calls) <= failures:
            raise RuntimeError(f"attempt {len(calls) - 1}")
        return f"done after {len(calls)}"

    try:
        result = ("returned", module.retry_call(fn, retries, 0.25,
                                                lambda a, e: seen.append((a, str(e)))))
    except RuntimeError as e:
        result = ("raised", str(e))
    return result, seen, sleeps, len(calls)


@pytest.mark.parametrize("retries", [0, 2, 3])
@pytest.mark.parametrize("outcome", ["recovers", "always_fails"])
def test_retry_call_matches_jax(monkeypatch, retries, outcome):
    failures = retries if outcome == "recovers" else retries + 5
    ours = _retry_trace(tretry, monkeypatch, retries, failures)
    assert ours == _retry_trace(jretry, monkeypatch, retries, failures)
    result, seen, sleeps, calls = ours
    assert calls == retries + 1
    assert result == (("returned", f"done after {retries + 1}") if outcome == "recovers"
                      else ("raised", f"attempt {retries}"))
    assert seen == [(a, f"attempt {a}") for a in range(retries)]
    assert sleeps == [0.25 * 2 ** a for a in range(retries)]


def _fields(cfg):
    """The config as a dict, each enum as (its class name, its value)."""
    return {k: (type(v).__name__, v.value) if isinstance(v, enum.Enum) else v
            for k, v in dataclasses.asdict(cfg).items()}


@pytest.mark.parametrize("factory,overrides", [
    ("zero_shot_config", {}),
    ("zero_shot_config", dict(prompt_mode="max", seed=99)),
    ("zero_shot_config", dict(adapter="mlp", shared=True)),
    ("class_incremental_config", {}),
    ("class_incremental_config", dict(more_labels=False, tasks_order=(4, 3, 2, 1, 0))),
    ("class_incremental_config", dict(continual_learning="myCL", threshold_scheduling=True)),
])
def test_config_factory_matches_jax(factory, overrides):
    ours = getattr(tconfig, factory)(**overrides)
    ref = getattr(jconfig, factory)(**overrides)
    mine, theirs = _fields(ours), _fields(ref)
    # the JAX fields that only steer a TPU have no counterpart in the port
    assert set(theirs) - set(mine) == {"compute_dtype", "data_axis"}
    assert mine == {k: theirs[k] for k in mine}
    assert ours.run_name() == ref.run_name()


@pytest.mark.parametrize("writer,reader", [(tckpt, jckpt), (jckpt, tckpt)],
                         ids=["port_to_jax", "jax_to_port"])
@pytest.mark.parametrize("aux", [None, {"rng": [1, 2, [3, 4]],
                                        "counters": {"step": 7, "heatmap": [[0.5]]}}])
def test_progress_file_crosses_packages(tmp_path, writer, reader, aux):
    writer.save_progress(tmp_path / "written", 3, aux)
    reader.save_progress(tmp_path / "own", 3, aux)
    assert (tmp_path / "written" / "progress.json").read_bytes() \
        == (tmp_path / "own" / "progress.json").read_bytes()
    assert reader.load_progress(tmp_path / "written") == 3
    assert reader.load_aux(tmp_path / "written") == aux


@pytest.mark.parametrize("class_name", tconfig.CHEXPERT_COMPETITION_TASKS)
def test_compositional_candidates_match_jax(class_name):
    ours = tprompts.compositional_candidates(class_name)
    assert len(ours) > 1
    assert ours == jprompts.compositional_candidates(class_name)


def _labels():
    """Multi-hot rows, shuffled: all-negative, all-positive, single-positive
    and mixed, enough of each that the subsets' caps bind."""
    rng = np.random.default_rng(24)
    rows = [np.zeros((12, 5)), np.ones((12, 5)), np.repeat(np.eye(5), 8, axis=0),
            rng.random((60, 5)) < 0.4]
    return rng.permutation(np.concatenate(rows)).astype(np.float32)


@pytest.mark.parametrize("name,kw,capped", [
    ("split_by_label", {}, None),
    ("filter_multiclass", dict(per_class=6), 5 * 6),
    ("filter_sani_malati", dict(per_group=9), 2 * 9),
    ("count_positive_labels", {}, None),
])
def test_store_subsets_match_jax(name, kw, capped):
    labels = _labels()
    emb = np.random.default_rng(25).standard_normal((len(labels), 8)).astype(np.float32)
    ours = getattr(tstore, name)(tstore.EmbeddingDataset(emb, labels), **kw)
    ref = getattr(jstore, name)(jstore.EmbeddingDataset(emb, labels), **kw)
    if isinstance(ours, np.ndarray):
        np.testing.assert_array_equal(ours, ref)
        return
    ours, ref = (x if isinstance(x, list) else [x] for x in (ours, ref))
    assert len(ours) == len(ref) and all(len(o) > 0 for o in ours)
    assert capped is None or len(ours[0]) == capped
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o.embeddings, r.embeddings)
        np.testing.assert_array_equal(o.labels, r.labels)
