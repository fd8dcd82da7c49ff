"""Eval step of the port (counterpart of `apply_missing_mask`,
`ClassificationTask` and `make_eval_step`, mmtpu/train/step.py).

A missing modality is zeroed in the RAW input before its encoder, by the
batch's `{mod}_mask` — not in the embedding: with BatchNorm running
statistics a zeroed image still gives a non-zero embedding, as in mmtpu.
In the port the model holds its weights, so the step takes only the batch.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Sequence

import numpy as np
import torch

from mmtpu_torch.train.losses import LossFunctionGroup


def apply_missing_mask(x: torch.Tensor, mask) -> torch.Tensor:
    """x · mask, broadcast over the non-batch axes; mask=None → x."""
    if mask is None:
        return x
    return x * mask.reshape(mask.shape[0], *([1] * (x.dim() - 1))).to(x.dtype)


def to_device(batch: Mapping[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """numpy batch → tensors on `device`."""
    return {
        k: torch.from_numpy(np.ascontiguousarray(v)).to(device, non_blocking=True)
        for k, v in batch.items()
    }


@dataclasses.dataclass
class ClassificationTask:
    """Multi-input classifier: inputs → logits → loss, predictions."""

    model: torch.nn.Module
    loss_group: LossFunctionGroup
    input_keys: Sequence[str] = ("audio", "image")

    def apply(self, batch: Mapping[str, torch.Tensor], *, train: bool) -> torch.Tensor:
        inputs = [
            apply_missing_mask(batch[k], batch.get(f"{k}_mask"))
            for k in self.input_keys
        ]
        self.model.train(train)
        return self.model(*inputs)

    def predictions(self, logits: torch.Tensor) -> torch.Tensor:
        return logits.argmax(dim=-1)

    def loss(self, logits, batch, sample_mask=None) -> torch.Tensor:
        return self.loss_group(logits, batch["labels"], sample_mask=sample_mask)["total_loss"]


def make_eval_step(task: ClassificationTask, device: torch.device) -> Callable:
    """(numpy batch) → dict of tensors on `device`: loss, preds, labels,
    logits, and pattern_id / sample_mask when the batch has them."""

    @torch.inference_mode()
    def step(batch: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        batch = to_device(batch, device)
        logits = task.apply(batch, train=False)
        sample_mask = batch.get("sample_mask")
        out = {
            "loss": task.loss(logits, batch, sample_mask=sample_mask),
            "preds": task.predictions(logits),
            "labels": batch["labels"],
            "logits": logits,
        }
        if "pattern_id" in batch:
            out["pattern_id"] = batch["pattern_id"]
        if sample_mask is not None:
            out["sample_mask"] = sample_mask
        return out

    return step
