"""Multimodal sentiment analysis metrics (own copy of mmtpu/metrics/msa.py,
on the port's numpy versions of sklearn's metrics).

Kept from the reference exactly:
- the `Recall_*` and `Precision_*` entries of `msa_binary_classification`
  hold the F1 value (the reference computes them with `f1_score`);
- every value is rounded to 4 places;
- `accuracy_score(preds, truth)` takes its arguments in that order;
- a split with no non-neutral label leaves `Non0` with empty arrays, and the
  metric then raises `ValueError` as sklearn does on empty input (the
  recorder reports it and leaves the metric out for that pattern).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from mmtpu_torch.metrics.classification import accuracy_score, confusion_matrix, f1_score


def msa_binarize(preds: np.ndarray, labels: np.ndarray):
    """3-class (0=neg, 1=neutral, 2=pos) → Has0/Non0 binary splits."""
    binary_truth = (labels == 1).astype(int)
    binary_preds = (preds == 1).astype(int)
    non_zero_idx = np.where(labels != 1)[0]
    nz_truth = (labels[non_zero_idx] == 2).astype(int)
    nz_preds = (preds[non_zero_idx] == 2).astype(int)
    return binary_preds, binary_truth, non_zero_idx, nz_preds, nz_truth


def _multiclass_acc(y_pred, y_true) -> float:
    return float(np.sum(np.round(y_pred) == np.round(y_true)) / len(y_true))


def confusion_matrix_from_logits(y_true, y_pred, **kwargs) -> np.ndarray:
    return confusion_matrix(y_true, y_pred, **kwargs)


def msa_binary_classification(y_true: np.ndarray, y_pred: np.ndarray) -> Dict[str, float]:
    """20 Has0_/Non0_ accuracy/F1/recall/precision keys (see the module doc)."""
    b_preds, b_truth, _nz_idx, nz_preds, nz_truth = msa_binarize(
        np.asarray(y_pred), np.asarray(y_true)
    )
    out: Dict[str, float] = {}
    for prefix, truth, preds in (
        ("Non0", nz_truth, nz_preds),
        ("Has0", b_truth, b_preds),
    ):
        out[f"{prefix}_Accuracy"] = round(accuracy_score(preds, truth), 4)
        for avg in ("weighted", "macro", "micro"):
            f1 = f1_score(truth, preds, average=avg)
            out[f"{prefix}_F1_{avg}"] = round(f1, 4)
            out[f"{prefix}_Recall_{avg}"] = round(f1, 4)
            out[f"{prefix}_Precision_{avg}"] = round(f1, 4)
    return out


def mosei_regression(y_true, y_pred) -> Dict[str, float]:
    """Regression metrics over [-3, 3] sentiment scores (the reference's
    `old_mosei_regression`)."""
    preds = np.asarray(y_pred, dtype=np.float64)
    truth = np.asarray(y_true, dtype=np.float64)

    preds_a7 = np.clip(preds, -3.0, 3.0)
    truth_a7 = np.clip(truth, -3.0, 3.0)
    preds_a5 = np.clip(preds, -2.0, 2.0)
    truth_a5 = np.clip(truth, -2.0, 2.0)

    non_zeros = np.where(truth != 0)[0]
    nz_truth = truth[non_zeros] > 0
    nz_preds = preds[non_zeros] > 0

    binary_truth = truth >= 0
    binary_preds = preds >= 0

    return {
        "Has0_Acc_2": round(accuracy_score(binary_preds, binary_truth), 4),
        "Has0_F1_score": round(f1_score(binary_truth, binary_preds, average="weighted"), 4),
        "Non0_Acc_2": round(accuracy_score(nz_preds, nz_truth), 4),
        "Non0_F1_score": round(f1_score(nz_truth, nz_preds, average="weighted"), 4),
        "Mult_Acc_5": round(_multiclass_acc(preds_a5, truth_a5), 4),
        "Mult_Acc_7": round(_multiclass_acc(preds_a7, truth_a7), 4),
    }


old_mosei_regression = mosei_regression
