"""Self-MM's train and eval steps (counterpart of mmtpu/train/self_mm_step.py).

The loss is the fusion prediction's L1 to the fusion label bank plus, for
audio, video and text, the L1 of that modality's prediction to its own
label bank, each row weighted by tanh(|y_m − y_f|); every term a masked
mean over the batch's real rows. Then, in this order:

- the optimizer's step (backward, the optional global-norm clip, Adam; a
  frozen BERT's parameters get zero gradients, as mmtpu's behind
  `stop_gradient`);
- from epoch 2 on (a host integer, so a Python `if`), the unimodal labels
  refined from the features' distances to the positive and negative
  centers: δ_f = (d_fn − d_fp)/(d_fp + ε), δ_s = (d_sn − d_sp)/d_sp + ε (the
  reference's placement of ε, kept), α = δ_s/(δ_f + ε), the new label
  ½·α·y_f + ½·(y_f + δ_s − δ_f) clipped to ±H and averaged with the old one
  as (e − 1)/(e + 1)·old + 2/(e + 1)·new;
- the batch's features (from the forward before the step, detached) into
  the feature bank, then the centers recomputed over the whole bank.

`SelfMMTask.apply` applies no missing mask, as mmtpu's does not: an `at`
pattern evaluates like `atv`. The eval loss is the masked L1 of the fusion
prediction to the label. On the GPU the two AuViSubNets launch the `lstm`
kernel once each per forward.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping

import numpy as np
import torch

from mmtpu_torch.train.losses import _masked_reduce
from mmtpu_torch.train.managers import ManagerState
from mmtpu_torch.train.state import TrainState
from mmtpu_torch.train.step import apply_gradients, to_device

MODALITIES = ("multimodal", "audio", "video", "text")
REFINE_EPS = 1e-8


@dataclasses.dataclass
class SelfMMTask:
    model: torch.nn.Module
    need_data_aligned: bool
    H: float = 3.0
    exclude_zero: bool = True

    def apply(self, batch: Mapping[str, torch.Tensor], *, train: bool):
        self.model.train(train)
        A = (batch["audio"], batch.get("audio_lengths"))
        V = (batch["video"], batch.get("video_lengths"))
        return self.model(A, V, batch["text"])


def weighted_l1(pred, target, weight=None, sample_mask=None) -> torch.Tensor:
    pred, target = pred.reshape(-1), target.reshape(-1)
    w = torch.ones_like(pred) if weight is None else weight
    if sample_mask is not None:
        w = w * sample_mask
        return (w * (pred - target).abs()).sum() / torch.clamp(sample_mask.sum(), min=1.0)
    return (w * (pred - target).abs()).mean()


def self_mm_loss(outputs, managers: ManagerState, idx, sample_mask) -> torch.Tensor:
    y_f = managers.get_labels("multimodal", idx)
    total = weighted_l1(outputs["predictions"]["multimodal"], y_f, sample_mask=sample_mask)
    for m in ("audio", "video", "text"):
        y_m = managers.get_labels(m, idx)
        total = total + weighted_l1(outputs["predictions"][m], y_m,
                                    torch.tanh((y_m - y_f).abs()), sample_mask=sample_mask)
    return total


def refine_labels(managers: ManagerState, features: Dict[str, torch.Tensor], idx,
                  epoch: int, H: float, sample_mask=None) -> ManagerState:
    """The unimodal labels' refinement from the centers (epoch > 1)."""
    f_fus = features["multimodal"]
    d_fp = torch.linalg.vector_norm(f_fus - managers.centers_pos["multimodal"], dim=-1)
    d_fn = torch.linalg.vector_norm(f_fus - managers.centers_neg["multimodal"], dim=-1)
    delta_f = (d_fn - d_fp) / (d_fp + REFINE_EPS)
    y_fus = managers.get_labels("multimodal", idx)
    e = torch.tensor(float(epoch), dtype=torch.float32, device=f_fus.device)  # mmtpu's float32
    for m in ("audio", "video", "text"):
        f = features[m]
        d_sp = torch.linalg.vector_norm(f - managers.centers_pos[m], dim=-1)
        d_sn = torch.linalg.vector_norm(f - managers.centers_neg[m], dim=-1)
        delta_s = (d_sn - d_sp) / d_sp + REFINE_EPS
        alpha = delta_s / (delta_f + REFINE_EPS)
        new = torch.clamp(0.5 * alpha * y_fus + 0.5 * (y_fus + delta_s - delta_f), -H, H)
        old = managers.get_labels(m, idx)
        new = (e - 1.0) / (e + 1.0) * old + 2.0 / (e + 1.0) * new
        managers.update_labels(m, idx, new, sample_mask=sample_mask)
    return managers


def _outputs(batch, loss, preds, sample_mask) -> Dict[str, torch.Tensor]:
    out = {"loss": loss, "preds": preds, "labels": batch["labels"]}
    if "pattern_id" in batch:
        out["pattern_id"] = batch["pattern_id"]
    if sample_mask is not None:
        out["sample_mask"] = sample_mask
    return out


def self_mm_train_step_core(task: SelfMMTask, state: TrainState, managers: ManagerState,
                            batch: Mapping[str, torch.Tensor], epoch: int):
    """One step on a batch already on the device; the banks updated in
    place. Returns the step's outputs (loss detached)."""
    idx, sm = batch["sample_idx"], batch.get("sample_mask")
    outputs = task.apply(batch, train=True)
    loss = self_mm_loss(outputs, managers, idx, sm)
    apply_gradients(state, loss)
    features = {m: outputs["features"][m].detach() for m in MODALITIES}
    if epoch > 1:
        refine_labels(managers, features, idx, epoch, task.H, sample_mask=sm)
    managers.update_features(features, idx, sample_mask=sm)
    managers.update_centers(exclude_zero=task.exclude_zero)
    preds = outputs["predictions"]["multimodal"].detach().reshape(-1)
    return _outputs(batch, loss.detach(), preds, sm)


def make_self_mm_train_step(task: SelfMMTask, state: TrainState,
                            device: torch.device) -> Callable:
    """(managers, numpy batch, epoch) → dict of tensors on `device`."""

    def step(managers: ManagerState, batch: Mapping[str, np.ndarray], epoch: int):
        return self_mm_train_step_core(task, state, managers, to_device(batch, device), epoch)

    return step


def make_self_mm_eval_step(task: SelfMMTask, device: torch.device) -> Callable:
    """(numpy batch) → dict of tensors on `device`: the masked L1 of the
    fusion prediction, preds, labels, pattern_id, sample_mask."""

    @torch.inference_mode()
    def step(batch: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        batch = to_device(batch, device)
        outputs = task.apply(batch, train=False)
        preds = outputs["predictions"]["multimodal"].reshape(-1)
        labels = batch["labels"].to(torch.float32).reshape(-1)
        sm = batch.get("sample_mask")
        return _outputs(batch, _masked_reduce((preds - labels).abs(), sm), preds, sm)

    return step


def init_manager_labels(managers: ManagerState, loader: Any) -> ManagerState:
    """The label banks prefilled from the train loader's real rows (the
    reference's `post_init_with_dataloaders`); one pass of the loader."""
    device = next(iter(managers.labels.values())).device
    for batch in loader:
        keep = batch["sample_mask"].astype(bool)
        idx = torch.from_numpy(np.asarray(batch["sample_idx"])[keep]).to(device)
        labels = torch.from_numpy(np.asarray(batch["labels"], np.float32)[keep]).to(device)
        managers.init_labels(idx, labels)
    return managers
