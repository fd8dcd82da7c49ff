"""numpy implementations of the sklearn classification metrics the configs
name, with sklearn's semantics (the card's machine has no sklearn).

`accuracy_score`, `confusion_matrix` (`labels`, `normalize`),
`precision_score` / `recall_score` / `f1_score` / `fbeta_score` (`average`
None | 'binary' | 'micro' | 'macro' | 'weighted', `labels`, `pos_label`,
`zero_division` 'warn' | 0 | 1 | nan) and `balanced_accuracy_score`
(`adjusted`), over 1-D integer label vectors (binary or multiclass). Empty
vectors raise `ValueError`, as in sklearn. Multilabel and sample-weighted
inputs are not covered there.

`mean_squared_error` and `mean_absolute_error`: sklearn's regression
semantics over (n,) or (n, outputs) arrays (the C-MAM reconstruction group
feeds them embeddings): `sample_weight`, `multioutput` 'uniform_average',
'raw_values' or per-output weights, float32 arithmetic when every input is
float32, float64 otherwise, and `ValueError` on empty input.
"""

from __future__ import annotations

import math
import warnings
from typing import Optional, Sequence

import numpy as np

_AVERAGES = (None, "binary", "micro", "macro", "weighted")


def _vectors(y_true, y_pred):
    y_true = np.asarray(y_true).reshape(-1)
    y_pred = np.asarray(y_pred).reshape(-1)
    if y_true.shape != y_pred.shape:
        raise ValueError(f"inconsistent numbers of samples: {y_true.shape[0]}, "
                         f"{y_pred.shape[0]}")
    if y_true.shape[0] == 0:  # as sklearn: every metric refuses empty input
        raise ValueError("Found empty input array (e.g., `y_true` or `y_pred`) while a "
                         "minimum of 1 sample is required.")
    return y_true, y_pred


def accuracy_score(y_true, y_pred, normalize: bool = True):
    y_true, y_pred = _vectors(y_true, y_pred)
    hits = y_true == y_pred
    return float(hits.mean()) if normalize else float(hits.sum())


def confusion_matrix(y_true, y_pred, labels: Optional[Sequence] = None,
                     normalize: Optional[str] = None) -> np.ndarray:
    """C[i, j]: samples of true label i predicted as j, over `labels` (the
    sorted union of both vectors by default); other labels are left out."""
    y_true, y_pred = _vectors(y_true, y_pred)
    labels = np.union1d(y_true, y_pred) if labels is None else np.asarray(labels)
    index = {v: i for i, v in enumerate(labels.tolist())}
    n = len(labels)
    ti = np.array([index.get(v, -1) for v in y_true.tolist()], np.int64)
    pi = np.array([index.get(v, -1) for v in y_pred.tolist()], np.int64)
    keep = (ti >= 0) & (pi >= 0)
    cm = np.bincount(ti[keep] * n + pi[keep], minlength=n * n).reshape(n, n).astype(np.int64)
    if normalize is None:
        return cm
    with np.errstate(all="ignore"):
        if normalize == "true":
            cm = cm / cm.sum(axis=1, keepdims=True)
        elif normalize == "pred":
            cm = cm / cm.sum(axis=0, keepdims=True)
        elif normalize == "all":
            cm = cm / cm.sum()
        else:
            raise ValueError("normalize must be one of {'true', 'pred', 'all', None}")
    return np.nan_to_num(cm)


def _zero_division_value(zero_division) -> float:
    if isinstance(zero_division, str) and zero_division == "warn":
        return 0.0
    if isinstance(zero_division, (int, float)) and zero_division in (0, 1):
        return float(zero_division)
    if isinstance(zero_division, float) and math.isnan(zero_division):
        return float("nan")
    raise ValueError(f"zero_division must be 'warn', 0, 1 or nan, got {zero_division!r}")


def _divide(num: np.ndarray, den: np.ndarray, zero_division) -> np.ndarray:
    num = np.asarray(num, np.float64)
    den = np.asarray(den, np.float64)
    out = num / np.where(den == 0, 1.0, den)
    out[den == 0] = _zero_division_value(zero_division)
    return out


def _nanaverage(values: np.ndarray, weights: Optional[np.ndarray] = None) -> float:
    """Weighted mean ignoring NaNs; all-zero weights fall back to the mean."""
    if values.shape[0] == 0:
        return float("nan")
    keep = ~np.isnan(values)
    if not keep.any():
        return float("nan")
    values = values[keep]
    if weights is None:
        return float(values.mean())
    weights = np.asarray(weights, np.float64)[keep]
    if weights.sum() == 0:
        return float(values.mean())
    return float(np.average(values, weights=weights))


def _labels_for(y_true, y_pred, average, labels, pos_label):
    if average not in _AVERAGES:
        raise ValueError("average has to be one of " + str(_AVERAGES))
    present = np.union1d(y_true, y_pred)
    if average == "binary":
        if len(present) > 2:
            raise ValueError("Target is multiclass but average='binary'. Please choose "
                             "another average setting, one of [None, 'micro', 'macro', "
                             "'weighted'].")
        if pos_label not in present.tolist() and len(present) >= 2:
            raise ValueError(f"pos_label={pos_label} is not a valid label. It should be "
                             f"one of {present.tolist()}")
        return np.asarray([pos_label])
    return present if labels is None else np.asarray(labels)


def precision_recall_fscore_support(y_true, y_pred, *, beta: float = 1.0, labels=None,
                                    pos_label=1, average=None, zero_division="warn"):
    y_true, y_pred = _vectors(y_true, y_pred)
    labels = _labels_for(y_true, y_pred, average, labels, pos_label)
    tp = np.array([np.sum((y_true == c) & (y_pred == c)) for c in labels], np.int64)
    pred_sum = np.array([np.sum(y_pred == c) for c in labels], np.int64)
    true_sum = np.array([np.sum(y_true == c) for c in labels], np.int64)
    if average == "micro":
        tp, pred_sum, true_sum = tp.sum(keepdims=True), pred_sum.sum(keepdims=True), \
            true_sum.sum(keepdims=True)
    zero = any(d.min(initial=1) == 0 for d in (pred_sum, true_sum))
    if zero and isinstance(zero_division, str) and zero_division == "warn":
        warnings.warn("ill-defined precision or recall: set to 0.0", UserWarning)
    precision = _divide(tp, pred_sum, zero_division)
    recall = _divide(tp, true_sum, zero_division)
    beta2 = beta ** 2
    f_score = _divide((1 + beta2) * tp, beta2 * true_sum + pred_sum, zero_division)
    if average is None:
        return precision, recall, f_score, true_sum
    weights = true_sum if average == "weighted" else None
    return (_nanaverage(precision, weights), _nanaverage(recall, weights),
            _nanaverage(f_score, weights), None)


def precision_score(y_true, y_pred, *, labels=None, pos_label=1, average="binary",
                    zero_division="warn"):
    return precision_recall_fscore_support(
        y_true, y_pred, labels=labels, pos_label=pos_label, average=average,
        zero_division=zero_division)[0]


def recall_score(y_true, y_pred, *, labels=None, pos_label=1, average="binary",
                 zero_division="warn"):
    return precision_recall_fscore_support(
        y_true, y_pred, labels=labels, pos_label=pos_label, average=average,
        zero_division=zero_division)[1]


def fbeta_score(y_true, y_pred, *, beta: float, labels=None, pos_label=1,
                average="binary", zero_division="warn"):
    return precision_recall_fscore_support(
        y_true, y_pred, beta=beta, labels=labels, pos_label=pos_label, average=average,
        zero_division=zero_division)[2]


def f1_score(y_true, y_pred, *, labels=None, pos_label=1, average="binary",
             zero_division="warn"):
    return fbeta_score(y_true, y_pred, beta=1.0, labels=labels, pos_label=pos_label,
                       average=average, zero_division=zero_division)


def balanced_accuracy_score(y_true, y_pred, *, adjusted: bool = False) -> float:
    """Mean recall over the classes present in y_true."""
    cm = confusion_matrix(y_true, y_pred)
    with np.errstate(divide="ignore", invalid="ignore"):
        per_class = np.diag(cm) / cm.sum(axis=1)
    if np.isnan(per_class).any():
        warnings.warn("y_pred contains classes not in y_true")
        per_class = per_class[~np.isnan(per_class)]
    score = float(per_class.mean())
    if adjusted:
        chance = 1 / per_class.shape[0]
        score = (score - chance) / (1 - chance)
    return score


def _regression_targets(y_true, y_pred, sample_weight, multioutput):
    """sklearn's `_check_reg_targets_with_floating_dtype`: 2-D float arrays
    of one dtype, the weights, and the output weighting."""
    arrays = [np.asarray(y_true), np.asarray(y_pred)]
    if sample_weight is not None:
        arrays.append(np.asarray(sample_weight))
    dtype = np.float32 if all(a.dtype == np.float32 for a in arrays) else np.float64
    y_true, y_pred = (a.astype(dtype, copy=False) for a in arrays[:2])
    if y_true.shape[0] != y_pred.shape[0]:
        raise ValueError(f"inconsistent numbers of samples: {y_true.shape[0]}, "
                         f"{y_pred.shape[0]}")
    if y_true.shape[0] == 0:
        raise ValueError(f"Found array with 0 sample(s) (shape={y_true.shape}) while a "
                         "minimum of 1 is required.")
    y_true = y_true.reshape(-1, 1) if y_true.ndim == 1 else y_true
    y_pred = y_pred.reshape(-1, 1) if y_pred.ndim == 1 else y_pred
    if y_true.shape[1] != y_pred.shape[1]:
        raise ValueError(f"y_true and y_pred have different number of output "
                         f"({y_true.shape[1]}!={y_pred.shape[1]})")
    weights = None
    if sample_weight is not None:
        weights = arrays[2].astype(dtype, copy=False).reshape(-1)
        if weights.shape[0] != y_true.shape[0]:
            raise ValueError(f"sample_weight.shape == {weights.shape}, expected "
                             f"{(y_true.shape[0],)}!")
    if isinstance(multioutput, str):
        if multioutput not in ("raw_values", "uniform_average"):
            raise ValueError("multioutput must be 'raw_values', 'uniform_average' or "
                             f"an array of output weights, got {multioutput!r}")
    else:
        multioutput = np.asarray(multioutput)
        if y_true.shape[1] == 1:
            raise ValueError("Custom weights are useful only in multi-output cases.")
        if multioutput.shape[0] != y_true.shape[1]:
            raise ValueError(f"There must be equally many custom weights "
                             f"({multioutput.shape[0]}) as outputs ({y_true.shape[1]}).")
    return y_true, y_pred, weights, multioutput


def _regression_average(errors, weights, multioutput):
    """Per-output weighted means over the samples, then over the outputs."""
    per_output = np.average(errors, axis=0, weights=weights)
    if isinstance(multioutput, str):
        if multioutput == "raw_values":
            return per_output
        multioutput = None
    return float(np.average(per_output, weights=multioutput))


def mean_squared_error(y_true, y_pred, *, sample_weight=None, multioutput="uniform_average"):
    y_true, y_pred, w, multioutput = _regression_targets(y_true, y_pred, sample_weight,
                                                         multioutput)
    return _regression_average((y_true - y_pred) ** 2, w, multioutput)


def mean_absolute_error(y_true, y_pred, *, sample_weight=None, multioutput="uniform_average"):
    y_true, y_pred, w, multioutput = _regression_targets(y_true, y_pred, sample_weight,
                                                         multioutput)
    return _regression_average(np.abs(y_pred - y_true), w, multioutput)
