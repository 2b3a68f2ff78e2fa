"""Port objectives/losses.py and evaluation/metrics.py: the loss and the
device metrics against the JAX package, the host metric set against
scikit-learn (which the port does not import)."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incremental_multimodal_medical_learning_ii_tpu.evaluation import metrics as jm
from incremental_multimodal_medical_learning_ii_tpu.objectives import losses as jl
from incremental_multimodal_medical_learning_ii_torch.evaluation import metrics as tm
from incremental_multimodal_medical_learning_ii_torch.objectives import losses as tl

from torch_port_helpers import assert_parity, one_torch_thread  # noqa: F401

ATOL = 1e-6  # the loss and device metrics vs JAX
SKLEARN_ATOL = 1e-12  # the host metric set vs scikit-learn


@pytest.mark.parametrize("masked", [False, True])
def test_bce_with_logits_matches_jax(rng, masked):
    x = (rng.normal(size=(33, 5)) * 3).astype(np.float32)
    x[0, 0] = 0.0  # the tie of max(x, 0)
    y = (rng.random((33, 5)) < 0.4).astype(np.float32)
    m = (rng.random((33, 5)) < 0.7).astype(np.float32) if masked else None
    ref = jl.bce_with_logits(jnp.asarray(x), jnp.asarray(y), None if m is None else jnp.asarray(m))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tl.bce_with_logits(xt, torch.from_numpy(y), None if m is None else torch.from_numpy(m))
    assert_parity(f"bce masked={masked}", got.detach().numpy(), np.asarray(ref), ATOL)
    # the gradient too, at the tie of max(x, 0) included
    import jax

    jgrad = jax.grad(lambda a: jl.bce_with_logits(
        a, jnp.asarray(y), None if m is None else jnp.asarray(m)))(jnp.asarray(x))
    (tgrad,) = torch.autograd.grad(got, xt)
    assert_parity(f"bce grad masked={masked}", tgrad.numpy(), np.asarray(jgrad), ATOL)
    empty = np.zeros_like(x)
    assert float(tl.bce_with_logits(torch.from_numpy(x), torch.from_numpy(y),
                                    torch.from_numpy(empty))) == 0.0


def test_change_labels_matches_jax():
    y = np.array([[0, 1, 1], [1, 0, 0]], np.float32)
    np.testing.assert_array_equal(tl.change_labels(torch.from_numpy(y)).numpy(),
                                  np.asarray(jl.change_labels(jnp.asarray(y))))


def _scores_with_ties(rng, n=120, c=5):
    s = rng.random((n, c)).astype(np.float32)
    s[:, 1] = np.round(s[:, 1] * 4) / 4  # five distinct values: heavy ties
    s[::7, 3] = s[3, 3]
    return s


@pytest.mark.parametrize("case", ["plain", "masked", "nan-class"])
def test_auroc_device_matches_jax(rng, case):
    s = _scores_with_ties(rng)
    y = (rng.random(s.shape) < 0.35).astype(np.float32)
    mask = np.ones(len(s), np.float32)
    if case != "plain":
        mask[rng.random(len(s)) < 0.3] = 0.0
    if case == "nan-class":
        y[:, 2] = 0.0  # no positives
        y[:, 4] = 1.0  # no negatives
    ref = np.asarray(jm.auroc_device(jnp.asarray(s), jnp.asarray(y), jnp.asarray(mask)))
    got = tm.auroc_device(torch.from_numpy(s), torch.from_numpy(y), torch.from_numpy(mask)).numpy()
    if case == "nan-class":
        assert np.isnan(got[[2, 4]]).all() and np.isnan(ref[[2, 4]]).all()
    assert_parity(f"auroc_device {case}", np.nan_to_num(got, nan=-1), np.nan_to_num(ref, nan=-1), ATOL)


def test_f1_and_subset_accuracy_device_match_jax(rng):
    p = (rng.random((50, 5)) < 0.4).astype(np.float32)
    y = (rng.random((50, 5)) < 0.4).astype(np.float32)
    p[:, 0] = 0.0
    y[:, 0] = 0.0  # no true and no predicted positives: F1 0
    y[:10] = p[:10]
    mask = (rng.random(50) < 0.8).astype(np.float32)
    args_j = [jnp.asarray(a) for a in (p, y, mask)]
    args_t = [torch.from_numpy(a) for a in (p, y, mask)]
    assert_parity("f1_device", tm.f1_device(*args_t).numpy(), np.asarray(jm.f1_device(*args_j)), ATOL)
    assert_parity("subset_accuracy_device", tm.subset_accuracy_device(*args_t).numpy(),
                  np.asarray(jm.subset_accuracy_device(*args_j)), ATOL)


def _eval_arrays(rng, case):
    n, c = 200, 5
    y = (rng.random((n, c)) < 0.3).astype(np.float32)
    s = rng.random((n, c)).astype(np.float32)
    if case == "ties":
        s = np.round(s * 8) / 8  # nine distinct scores per class
    p = (s > 0.5).astype(np.float32)
    if case == "no-predicted-positives":
        p[:, 1] = 0.0
        p[:, 3] = 0.0
    if case == "one-label-value":
        y[:, 2] = 0.0  # AUROC undefined for that class
    return y, p, s


@pytest.mark.parametrize("case", ["plain", "ties", "no-predicted-positives", "one-label-value"])
def test_host_metrics_match_sklearn(rng, case):
    from sklearn.metrics import (
        accuracy_score,
        f1_score,
        precision_score,
        recall_score,
        roc_auc_score,
    )

    y, p, s = _eval_arrays(rng, case)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = jm.compute_metrics(y, p, s)
        ref_pc = jm.per_class_metrics(y, p, s)
        # the exact calls the reference makes, beside the JAX package's wrapper
        assert ref["accuracy"] == accuracy_score(y, p)
        assert ref["f1_macro"] == f1_score(y, p, average="macro")
        assert ref["auroc_macro"] == roc_auc_score(y, s, average="macro") or case == "one-label-value"
        assert ref["precision_weighted"] == precision_score(y, p, average="weighted", zero_division=0)
        assert ref["recall_weighted"] == recall_score(y, p, average="weighted", zero_division=0)
    got = tm.compute_metrics(y, p, s)
    got_pc = tm.per_class_metrics(y, p, s)
    assert set(got) == set(ref)
    for k in ref:
        if np.isnan(ref[k]):
            assert np.isnan(got[k]), k
        else:
            assert abs(got[k] - ref[k]) <= SKLEARN_ATOL, (k, got[k], ref[k])
    for k in ref_pc:
        np.testing.assert_allclose(got_pc[k], ref_pc[k], atol=SKLEARN_ATOL, rtol=0, err_msg=k)
    print(f"PARITY host metrics {case}: max |port - sklearn| = "
          f"{max(abs(got[k] - ref[k]) for k in ref if not np.isnan(ref[k])):.3e}")


def test_metrics_module_imports_no_sklearn():
    import ast
    from pathlib import Path

    src = Path(tm.__file__).read_text()
    roots = {n.names[0].name.split(".")[0] for n in ast.walk(ast.parse(src)) if isinstance(n, ast.Import)}
    roots |= {n.module.split(".")[0] for n in ast.walk(ast.parse(src))
              if isinstance(n, ast.ImportFrom) and n.module}
    assert "sklearn" not in roots
