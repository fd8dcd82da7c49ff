"""Loss criteria the eval step needs (counterpart of `cross_entropy`,
`_masked_reduce` and `LossFunctionGroup` in `mmtpu/train/losses.py`).

Call contract as in mmtpu: ``loss_functions(logits, labels,
sample_mask=...)["total_loss"]``. Only `cross_entropy` without extra
arguments is ported so far; other criteria raise when the config is loaded.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F


def _masked_reduce(per_sample, sample_mask=None):
    """Masked batch mean: sum(m·l) / sum(m). sample_mask zeroes padded tail
    rows so fixed-shape batches don't bias the loss."""
    if sample_mask is None:
        return per_sample.mean()
    return (per_sample * sample_mask).sum() / torch.clamp(sample_mask.sum(), min=1e-8)


def cross_entropy(logits, targets, sample_mask=None):
    """Softmax CE over integer class targets (torch CrossEntropyLoss)."""
    losses = F.cross_entropy(logits.float(), targets.long(), reduction="none")
    return _masked_reduce(losses, sample_mask)


_CRITERIA = {"cross_entropy": cross_entropy}


class LossFunctionGroup:
    """Named weighted loss terms; calling sums them into 'total_loss'.

    Built from the config mapping ``{term: {loss_name, loss_args, weight}}``,
    which it keeps for `to_dict`."""

    def __init__(self, spec: Dict[str, Dict[str, Any]]) -> None:
        self.spec = spec
        self.terms = []
        for term, data in spec.items():
            name = data["loss_name"].lower()
            if name not in _CRITERIA or data.get("loss_args") or data.get("loss_kwargs"):
                raise ValueError(
                    f"loss term {term!r} ({data}) is not ported to mmtpu_torch yet "
                    f"(available: {sorted(_CRITERIA)} without arguments)"
                )
            self.terms.append((_CRITERIA[name], float(data.get("weight", 1.0))))

    @classmethod
    def from_dict(cls, data: Dict[str, Dict[str, Any]]) -> "LossFunctionGroup":
        return data if isinstance(data, cls) else cls(dict(data))

    def __call__(self, inputs, targets, sample_mask: Optional[torch.Tensor] = None):
        total = sum(w * fn(inputs, targets, sample_mask=sample_mask) for fn, w in self.terms)
        return {"total_loss": total}

    def to_dict(self) -> Dict[str, Any]:
        return self.spec
