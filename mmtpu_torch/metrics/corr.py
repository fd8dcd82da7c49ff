"""Correlation and similarity metrics (own copy of mmtpu/metrics/corr.py,
and of the `cosine_similarity` of mmtpu/metrics/__init__.py in numpy)."""

from __future__ import annotations

import numpy as np


def pearson(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    return float(np.corrcoef(y_true, y_pred)[0][1])


def _rows_normalised(x: np.ndarray) -> np.ndarray:
    """Rows scaled to unit L2 norm; all-zero rows stay zero (sklearn's
    `normalize`)."""
    norms = np.sqrt(np.einsum("ij,ij->i", x, x))
    norms[norms == 0.0] = 1.0
    return x / norms[:, None]


def cosine_similarity(a, b, dense_output=True):
    """Mean pairwise cosine similarity of the rows of `a` and `b` (`b` None:
    of `a` with itself), as the mean of sklearn's
    `pairwise.cosine_similarity`: 2-D inputs, float32 when both are float32,
    else float64. `dense_output` is accepted for the same signature; inputs
    here are always dense."""
    x = np.asarray(a)
    y = x if b is None else np.asarray(b)
    dtype = np.float32 if x.dtype == np.float32 and y.dtype == np.float32 else np.float64
    x, y = x.astype(dtype, copy=False), y.astype(dtype, copy=False)
    if x.ndim != 2 or y.ndim != 2:
        raise ValueError(f"cosine_similarity takes 2-D arrays, got {x.shape} and {y.shape}")
    if x.shape[1] != y.shape[1]:
        raise ValueError(f"incompatible dimension for X and Y matrices: {x.shape[1]} != "
                         f"{y.shape[1]}")
    return (_rows_normalised(x) @ _rows_normalised(y).T).mean()
