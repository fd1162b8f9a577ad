"""Evaluation metric suite (counterpart of
``immunostruct_tpu/procedures/metrics.py``; reference:
procedures/metric.py:6-115).

Numpy implementations of the sklearn calls the reference uses (roc_curve /
roc_auc, precision_recall_curve + trapezoid AUC, accuracy / precision /
recall / F1), plus PPVn and Youden-threshold selection.

Quirk parity: ``evaluate_metrics`` feeds *binarized* predictions
(probs >= threshold) into mean_PPVn, exactly as the reference does
(metric.py:76-79) — so the PPVn columns measure the ranking of the
thresholded 0/1 vector, not the raw scores.
"""

from __future__ import annotations

import numpy as np


def mean_ppvn(values_true: np.ndarray, values_pred: np.ndarray, topk=None) -> float:
    """Mean positive predictive value over the top-n ranks, n = #positives
    (metric.py:6-41, cross-checked against the BigMHC implementation)."""
    values_true = np.asarray(values_true)
    values_pred = np.asarray(values_pred)
    assert len(values_true) == len(values_pred)

    order = np.argsort(values_pred)[::-1]
    sorted_true = values_true[order]
    cum_tp = np.cumsum(sorted_true)
    ppvn = cum_tp / np.arange(1, len(sorted_true) + 1)
    num_pos = int(values_true.sum())
    head = ppvn[:num_pos]
    if topk is not None and topk < len(head):
        head = head[:topk]
    return float(np.mean(head)) if len(head) else float("nan")


def roc_curve(y_true: np.ndarray, y_score: np.ndarray):
    """(fpr, tpr, thresholds) matching sklearn.roc_curve semantics:
    thresholds descend, curve starts at (0, 0) with threshold inf."""
    y_true = np.asarray(y_true).astype(float)
    y_score = np.asarray(y_score).astype(float)
    order = np.argsort(-y_score, kind="stable")
    y_true, y_score = y_true[order], y_score[order]

    distinct = np.nonzero(np.diff(y_score))[0]
    threshold_idx = np.r_[distinct, y_true.size - 1]

    tps = np.cumsum(y_true)[threshold_idx]
    fps = 1 + threshold_idx - tps
    thresholds = y_score[threshold_idx]

    tps = np.r_[0.0, tps]
    fps = np.r_[0.0, fps]
    thresholds = np.r_[np.inf, thresholds]

    p = max(tps[-1], 1.0)
    n = max(fps[-1], 1.0)
    return fps / n, tps / p, thresholds


def roc_auc_score(y_true: np.ndarray, y_score: np.ndarray) -> float:
    fpr, tpr, _ = roc_curve(y_true, y_score)
    return float(np.trapezoid(tpr, fpr))


def precision_recall_curve(y_true: np.ndarray, y_score: np.ndarray):
    """(precision, recall, thresholds), sklearn layout: ascending-threshold
    points followed by the (1, 0) endpoint."""
    y_true = np.asarray(y_true).astype(float)
    y_score = np.asarray(y_score).astype(float)
    order = np.argsort(-y_score, kind="stable")
    y_true, y_score = y_true[order], y_score[order]

    distinct = np.nonzero(np.diff(y_score))[0]
    threshold_idx = np.r_[distinct, y_true.size - 1]

    tps = np.cumsum(y_true)[threshold_idx]
    fps = 1 + threshold_idx - tps
    precision = tps / (tps + fps)
    total_pos = y_true.sum()
    recall = tps / total_pos if total_pos > 0 else np.zeros_like(tps)

    # sklearn reverses the curve (ascending recall -> descending) and appends
    # the (precision=1, recall=0) endpoint
    sl = slice(None, None, -1)
    precision = np.r_[precision[sl], 1.0]
    recall = np.r_[recall[sl], 0.0]
    thresholds = y_score[threshold_idx][sl]
    return precision, recall, thresholds


def precision_recall_auc(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Trapezoid AUC over the PR curve: the reference computes
    auc(recall_curve, precision_curve) (metric.py:66-67). Like sklearn.auc,
    a monotonically-decreasing x axis flips the sign rather than re-sorting
    (re-sorting would re-pair tied-recall points)."""
    precision, recall, _ = precision_recall_curve(y_true, y_score)
    area = float(np.trapezoid(precision, recall))
    dx = np.diff(recall)
    if np.all(dx <= 0):
        area = -area
    return area


def find_optimal_threshold(y_true: np.ndarray, y_prob: np.ndarray) -> float:
    """Maximize Youden's J = tpr - fpr over ROC thresholds (metric.py:43-61)."""
    fpr, tpr, thresholds = roc_curve(y_true, y_prob)
    j = tpr - fpr
    # skip the leading inf threshold if it maximizes J degenerately
    idx = int(np.argmax(j))
    thr = thresholds[idx]
    if not np.isfinite(thr):
        thr = thresholds[1] if len(thresholds) > 1 else 0.5
    thr = float(thr)
    assert 0.0 <= thr <= 1.0, f"threshold {thr} outside [0, 1]"
    return thr


def _binary_counts(y_true, y_pred):
    y_true = np.asarray(y_true).astype(bool)
    y_pred = np.asarray(y_pred).astype(bool)
    tp = int(np.sum(y_true & y_pred))
    fp = int(np.sum(~y_true & y_pred))
    fn = int(np.sum(y_true & ~y_pred))
    tn = int(np.sum(~y_true & ~y_pred))
    return tp, fp, fn, tn


def accuracy_score(y_true, y_pred) -> float:
    tp, fp, fn, tn = _binary_counts(y_true, y_pred)
    return (tp + tn) / max(tp + fp + fn + tn, 1)


def precision_score(y_true, y_pred) -> float:
    tp, fp, _, _ = _binary_counts(y_true, y_pred)
    return tp / (tp + fp) if (tp + fp) else 0.0


def recall_score(y_true, y_pred) -> float:
    tp, _, fn, _ = _binary_counts(y_true, y_pred)
    return tp / (tp + fn) if (tp + fn) else 0.0


def f1_score(y_true, y_pred) -> float:
    p, r = precision_score(y_true, y_pred), recall_score(y_true, y_pred)
    return 2 * p * r / (p + r) if (p + r) else 0.0


def evaluate_metrics(true_targets: np.ndarray, predicted_probs: np.ndarray,
                     optimal_threshold: float, verbose: bool = True) -> dict:
    """Full 15-entry metric dict (metric.py:64-115)."""
    y = np.asarray(true_targets)
    p = np.asarray(predicted_probs)

    at_05 = p >= 0.5
    at_op = p >= optimal_threshold

    out = {
        "optimal_threshold": float(optimal_threshold),
        "roc_auc": roc_auc_score(y, p),
        "pr_auc": precision_recall_auc(y, p),
        "accuracy": accuracy_score(y, at_05),
        "accuracy_op": accuracy_score(y, at_op),
        "f1": f1_score(y, at_05),
        "f1_op": f1_score(y, at_op),
        "precision": precision_score(y, at_05),
        "precision_op": precision_score(y, at_op),
        "recall": recall_score(y, at_05),
        "recall_op": recall_score(y, at_op),
        # quirk parity: PPVn over binarized predictions (metric.py:76-79),
        # passed as the raw BOOLEAN array exactly like the reference —
        # np.argsort's unstable sort permutes ties differently per dtype,
        # so casting to float changes the PPVn tie order (caught by the
        # executed-reference harness, tests/test_reference_executed.py)
        "ppvn": mean_ppvn(y, at_05),
        "ppvn_op": mean_ppvn(y, at_op),
        "ppv30": mean_ppvn(y, at_05, topk=30),
        "ppv30_op": mean_ppvn(y, at_op, topk=30),
    }
    if verbose:
        for k, v in out.items():
            print(f"{k}: {v:.4f}")
    return out
