"""Metric functions of the port, for hosts without sklearn: numpy versions
of the sklearn metrics the configs name (`sklearn.metrics.*`, in
`classification`), and mmtpu's own metrics package (`metrics.<name>` in a
config resolves here, as mmtpu resolves it onto `mmtpu.metrics`)."""

from mmtpu_torch.metrics.corr import cosine_similarity, pearson
from mmtpu_torch.metrics.msa import (
    confusion_matrix_from_logits,
    mosei_regression,
    msa_binary_classification,
    old_mosei_regression,
)

__all__ = [
    "pearson",
    "cosine_similarity",
    "msa_binary_classification",
    "confusion_matrix_from_logits",
    "mosei_regression",
    "old_mosei_regression",
]
