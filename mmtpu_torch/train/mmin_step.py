"""MMIN train and eval steps (counterpart of mmtpu/train/mmin_step.py).

    loss = CE(logits) + MSE(fusion, recon_fusion)
         + cycle-MSE(fusion, recon_cycle)
         [+ MSE(recon_fusion, teacher embedding), weighted by 'mse']

Each term is a per-sample mean over features, masked over padded rows and
weighted by its loss group entry (1 when the group has none). In training
the cycle term's target is the detached fusion; the eval loss uses the live
fusion and no teacher term (ce + mse + cycle, the reference's eval). The
frozen UttFusion teacher encodes the *complement* inputs, x · (1 − mask)
per modality (zeros for a modality with no mask key), under `no_grad`: its
embedding is the imputation target. Its netA and netV run one `lstm` launch
each (`encode`), the student's pair one: three per train batch, one per
eval batch. Padded rows stay out of BatchNorm (the sample mask is published
when the host batch has them).

The steps take numpy batches and return device tensors, as
`train/step.py`'s do; the train step's `losses` are {ce, mse, cycle}.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mmtpu_torch.models.norm import batch_mask
from mmtpu_torch.train.losses import LossFunctionGroup, _masked_reduce
from mmtpu_torch.train.state import TrainState
from mmtpu_torch.train.step import apply_gradients, apply_missing_mask, has_padded_rows, to_device

MODS = ("audio", "video", "text")


def masked(batch: Mapping[str, torch.Tensor], mod: str, invert: bool = False) -> torch.Tensor:
    """The modality with its pattern's missing mask (or the complement)."""
    return apply_missing_mask(batch[mod], batch.get(f"{mod}_mask"), invert=invert)


def loss_weight(loss_group: LossFunctionGroup, key: str) -> float:
    return loss_group[key].weight if key in loss_group else 1.0


def masked_ce(logits: torch.Tensor, labels: torch.Tensor, sample_mask) -> torch.Tensor:
    """Softmax CE over integer labels in float32, masked mean over real rows."""
    per = F.cross_entropy(logits.float(), labels.long(), reduction="none")
    return _masked_reduce(per, sample_mask)


def _feature_mse(a: torch.Tensor, b: torch.Tensor, sample_mask) -> torch.Tensor:
    return _masked_reduce(((a - b) ** 2).mean(dim=-1), sample_mask)


def mmin_losses(task: "MMINTask", res: Dict[str, torch.Tensor], batch,
                stop_grad_fusion: bool = True):
    """(ce, mse, cycle), each weighted (mmtpu's `_mmin_losses`)."""
    sm = batch.get("sample_mask")
    lg = task.loss_group
    loss_ce = loss_weight(lg, "cross_entropy") * masked_ce(res["logits"],
                                                           batch[task.label_key], sm)
    loss_mse = loss_weight(lg, "mse") * _feature_mse(res["fusion"], res["recon_fusion"], sm)
    fusion_ref = res["fusion"].detach() if stop_grad_fusion else res["fusion"]
    loss_cycle = loss_weight(lg, "cycle") * _feature_mse(fusion_ref, res["recon_cycle"], sm)
    return loss_ce, loss_mse, loss_cycle


@dataclasses.dataclass
class MMINTask:
    model: nn.Module
    loss_group: LossFunctionGroup
    teacher_model: Optional[nn.Module] = None  # the frozen UttFusion
    label_key: str = "labels"

    def __post_init__(self) -> None:
        if self.teacher_model is not None:
            self.teacher_model.eval()
            self.teacher_model.requires_grad_(False)

    def apply(self, batch, *, train: bool, bn_mask=None) -> Dict[str, torch.Tensor]:
        self.model.train(train)
        with batch_mask(bn_mask):
            return self.model(*(masked(batch, m) for m in MODS))

    def teacher_embeddings(self, batch) -> Optional[torch.Tensor]:
        """The teacher's embedding of the complement inputs, or None."""
        if self.teacher_model is None:
            return None
        with torch.no_grad():
            outs = self.teacher_model.encode(*(masked(batch, m, invert=True) for m in MODS))
        return torch.cat(list(outs), dim=-1)


def _outputs(task: MMINTask, batch, loss, logits, **extra) -> Dict[str, torch.Tensor]:
    out = {"loss": loss, **extra, "preds": logits.argmax(dim=-1),
           "labels": batch[task.label_key]}
    for key in ("pattern_id", "sample_mask"):
        if key in batch:
            out[key] = batch[key]
    return out


def mmin_train_step_core(task: MMINTask, state: TrainState, batch, padded: bool = True):
    """One gradient step on a batch already on the device. Returns the
    detached loss, the {ce, mse, cycle} terms and the logits."""
    sm = batch.get("sample_mask")
    res = task.apply(batch, train=True, bn_mask=sm if padded else None)
    loss_ce, loss_mse, loss_cycle = mmin_losses(task, res, batch)
    total = loss_ce + loss_mse + loss_cycle
    teacher = task.teacher_embeddings(batch)
    if teacher is not None:
        total = total + loss_weight(task.loss_group, "mse") * _feature_mse(
            res["recon_fusion"], teacher, sm)
    apply_gradients(state, total)
    terms = {"ce": loss_ce.detach(), "mse": loss_mse.detach(), "cycle": loss_cycle.detach()}
    return total.detach(), terms, res["logits"].detach()


def make_mmin_train_step(task: MMINTask, state: TrainState, device: torch.device) -> Callable:
    """(numpy batch) → dict of tensors on `device`: loss, losses, preds,
    labels, and pattern_id / sample_mask when the batch has them."""

    def step(batch: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        padded = has_padded_rows(batch)
        batch = to_device(batch, device)
        loss, terms, logits = mmin_train_step_core(task, state, batch, padded)
        return _outputs(task, batch, loss, logits, losses=terms)

    return step


def make_mmin_eval_step(task: MMINTask, device: torch.device) -> Callable:
    @torch.inference_mode()
    def step(batch: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        batch = to_device(batch, device)
        res = task.apply(batch, train=False)
        loss_ce, loss_mse, loss_cycle = mmin_losses(task, res, batch, stop_grad_fusion=False)
        return _outputs(task, batch, loss_ce + loss_mse + loss_cycle, res["logits"])

    return step
