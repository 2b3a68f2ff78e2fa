"""Evaluation metrics (counterpart of the JAX package's
``evaluation/metrics.py``).

The host half, :func:`compute_metrics` and :func:`per_class_metrics`, is
the exact metric set the reference computes with scikit-learn
(``Trainer.py:868-943``), re-implemented in numpy because the card's
machine has no scikit-learn: multilabel subset accuracy; F1 macro,
weighted and per class (0.0 where a class has no true and no predicted
positive); ROC AUC macro, weighted (by positive count) and per class, by
the trapezoid over sklearn's ROC curve (ties as one step, collinear points
dropped), NaN for a class with one label value; precision and recall
weighted and per class with 0 for an empty denominator.  The TB metric
scalars come from here.  The figures' curve points are sklearn's too:
:func:`roc_curve` (``drop_intermediate=True``, the leading ``(0, 0, inf)``
point), :func:`precision_recall_curve` (the closing ``(1, 0)`` point) and
:func:`average_precision_score`, over :func:`binary_clf_curve`'s distinct
scores in descending order.

The device half, :func:`auroc_device`, :func:`f1_device` and
:func:`subset_accuracy_device`, computes in torch on whatever device the
tensors live, without a readback: AUROC by the rank statistic with average
ranks for ties (a stable sort, as ``jnp.argsort`` is), masked rows sorted
to the front with zero weight, NaN for a class with no valid positive or
no valid negative.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_trapezoid = getattr(np, "trapezoid", None) or np.trapz


# ----------------------------------------------------------------------
# Host half (numpy; the sklearn metric set)
# ----------------------------------------------------------------------
def binary_clf_curve(y_true: np.ndarray, y_score: np.ndarray):
    """sklearn's ``confusion_matrix_at_thresholds`` of one binary column
    (positive label 1): the false and true positive counts (float64) at
    each distinct score, scores in descending order, and those scores."""
    y_true = (np.ravel(y_true) == 1).astype(np.float64)
    y_score = np.ravel(y_score)
    order = np.argsort(y_score, kind="stable")[::-1]
    y_score, y_true = y_score[order], y_true[order]
    idx = np.concatenate([np.nonzero(np.diff(y_score))[0], [y_true.size - 1]])
    tps = np.cumsum(y_true)[idx]
    fps = 1 + idx.astype(np.float64) - tps
    return fps, tps, y_score[idx]


def roc_curve(y_true: np.ndarray, y_score: np.ndarray):
    """``sklearn.metrics.roc_curve(drop_intermediate=True)``: (fpr, tpr,
    thresholds); NaN rates where a column has no negative (fpr) or no
    positive (tpr)."""
    fps, tps, thresholds = binary_clf_curve(y_true, y_score)
    if fps.shape[0] > 2:  # drop points collinear with their neighbours
        keep = np.where(np.concatenate(
            [[True], np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), [True]]))[0]
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    tps = np.concatenate([[0.0], tps])
    fps = np.concatenate([[0.0], fps])
    thresholds = np.concatenate([[np.inf], thresholds.astype(np.float64)])
    fpr = np.full(fps.shape, np.nan) if fps[-1] <= 0 else fps / fps[-1]
    tpr = np.full(tps.shape, np.nan) if tps[-1] <= 0 else tps / tps[-1]
    return fpr, tpr, thresholds


def precision_recall_curve(y_true: np.ndarray, y_score: np.ndarray):
    """``sklearn.metrics.precision_recall_curve``: (precision, recall,
    thresholds), recall decreasing, ending at precision 1, recall 0."""
    fps, tps, thresholds = binary_clf_curve(y_true, y_score)
    ps = tps + fps
    precision = np.where(ps != 0, tps / np.where(ps != 0, ps, 1.0), 0.0)
    recall = np.ones(tps.shape) if tps[-1] == 0 else tps / tps[-1]
    return (np.concatenate([precision[::-1], [1.0]]), np.concatenate([recall[::-1], [0.0]]),
            thresholds[::-1])


def average_precision_score(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """``sklearn.metrics.average_precision_score`` of one binary column:
    the step sum of precision over the recall increments."""
    precision, recall, _ = precision_recall_curve(y_true, y_score)
    return float(max(0.0, -np.sum(np.diff(recall) * precision[:-1])))


def _binary_roc_auc(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """``roc_auc_score`` of one binary column: the trapezoid under
    :func:`roc_curve`; NaN if only one label value is present."""
    if len(np.unique(np.asarray(y_true) == 1)) != 2:
        return float("nan")
    fpr, tpr, _ = roc_curve(y_true, y_score)
    return float(_trapezoid(tpr, fpr))


def _counts(y_true: np.ndarray, y_pred: np.ndarray):
    t, p = np.asarray(y_true) == 1, np.asarray(y_pred) == 1
    tp = np.sum(t & p, axis=0).astype(np.float64)
    return tp, np.sum(p, axis=0).astype(np.float64), np.sum(t, axis=0).astype(np.float64)


def _divide(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    """num / den, 0.0 where den == 0 (sklearn's zero_division=0 and 'warn')."""
    num, den = np.atleast_1d(num).astype(np.float64), np.atleast_1d(den).astype(np.float64)
    out = num / np.where(den == 0, 1.0, den)
    out[den == 0] = 0.0
    return out


def _weighted(values: np.ndarray, weights: np.ndarray) -> float:
    return float(np.average(values, weights=weights))


def compute_metrics(y_true: np.ndarray, y_pred: np.ndarray, y_score: np.ndarray) -> Dict[str, float]:
    """The exact metric set of ``Trainer.evaluate_model`` (Trainer.py:871-877)."""
    tp, pred_sum, true_sum = _counts(y_true, y_pred)
    f1 = _divide(2.0 * tp, true_sum + pred_sum)
    auroc = np.array([_binary_roc_auc(y_true[:, i], y_score[:, i])
                      for i in range(y_true.shape[1])], np.float64)
    auroc_w = auroc.copy()
    auroc_w[true_sum == 0] = 0.0
    return {
        "accuracy": float(np.mean(np.all(np.asarray(y_true) == np.asarray(y_pred), axis=1))),
        "f1_macro": float(np.mean(f1)),
        "f1_weighted": _weighted(f1, true_sum),
        "auroc_macro": float(np.mean(auroc)),
        "auroc_weighted": (0.0 if np.isclose(np.sum(true_sum), 0.0)
                           else _weighted(auroc_w, true_sum)),
        "precision_weighted": _weighted(_divide(tp, pred_sum), true_sum),
        "recall_weighted": _weighted(_divide(tp, true_sum), true_sum),
    }


def per_class_metrics(
    y_true: np.ndarray, y_pred: np.ndarray, y_score: np.ndarray
) -> Dict[str, np.ndarray]:
    """Per-class rows for the epoch x class / task x class heatmaps and the
    accuracy/precision/recall scatter plots (Trainer.py:922-943)."""
    tp, pred_sum, true_sum = _counts(y_true, y_pred)
    return {
        "f1": _divide(2.0 * tp, true_sum + pred_sum),
        "auroc": np.array([_binary_roc_auc(y_true[:, i], y_score[:, i])
                           for i in range(y_true.shape[1])], np.float64),
        "accuracy": np.mean(np.asarray(y_true) == np.asarray(y_pred), axis=0).astype(np.float64),
        "precision": _divide(tp, pred_sum),
        "recall": _divide(tp, true_sum),
    }


# ----------------------------------------------------------------------
# Device half (torch; no readback)
# ----------------------------------------------------------------------
def auroc_device(scores: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-class AUROC (C,) via the rank statistic (Mann-Whitney U)."""
    n, c = scores.shape
    n_masked = n - torch.sum(mask)
    ranks = torch.arange(1, n + 1, dtype=torch.float32, device=scores.device)

    def one_class(s, y):
        # masked rows sort to the very front (rank 1..n_masked) with zero
        # weight; subtracting n_masked restores the valid-only ranks
        s = torch.where(mask > 0, s, -torch.inf)
        order = torch.argsort(s, stable=True)
        s_sorted, y_sorted, m_sorted = s[order], y[order], mask[order]
        same_as_prev = torch.cat([torch.zeros(1, dtype=torch.bool, device=s.device),
                                  s_sorted[1:] == s_sorted[:-1]])
        grp = torch.cumsum((~same_as_prev).to(torch.int64), 0)
        grp_sum = torch.zeros(n + 1, device=s.device).index_add(0, grp, ranks)
        grp_cnt = torch.zeros(n + 1, device=s.device).index_add(0, grp, torch.ones_like(ranks))
        avg_rank = (grp_sum / torch.clamp(grp_cnt, min=1.0))[grp] - n_masked
        n_pos = torch.sum(y_sorted * m_sorted)
        n_neg = torch.sum((1 - y_sorted) * m_sorted)
        u = torch.sum(avg_rank * y_sorted * m_sorted) - n_pos * (n_pos + 1) / 2.0
        return torch.where(n_pos * n_neg > 0, u / torch.clamp(n_pos * n_neg, min=1.0),
                           torch.nan)

    return torch.stack([one_class(scores[:, i], labels[:, i]) for i in range(c)])


def f1_device(preds: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-class binary F1 (C,)."""
    m = mask[:, None]
    tp = torch.sum(preds * labels * m, dim=0)
    fp = torch.sum(preds * (1 - labels) * m, dim=0)
    fn = torch.sum((1 - preds) * labels * m, dim=0)
    return 2 * tp / torch.clamp(2 * tp + fp + fn, min=1.0)


def subset_accuracy_device(preds: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    exact = torch.all(preds == labels, dim=1).to(torch.float32)
    return torch.sum(exact * mask) / torch.clamp(torch.sum(mask), min=1.0)
