"""Train and eval steps of the port (counterpart of `apply_missing_mask`,
`ClassificationTask`, `train_step_core`, `make_train_step` and
`make_eval_step`, mmtpu/train/step.py).

A missing modality is zeroed in the RAW input before its encoder, by the
batch's `{mod}_mask` — not in the embedding: with BatchNorm running
statistics a zeroed image still gives a non-zero embedding, as in mmtpu.
In the port the model holds its weights, so a step takes only the batch
(and the train step the `TrainState`). Outputs stay on the device: the
loop copies them to the host once per epoch.

The train step runs the train-mode forward with the batch's sample mask
published to BatchNorm (`models/norm.py`), the padded-row-masked loss,
backward, the optional global-norm clip and `optimizer.step()`. The mask
is published only when the host batch has padded rows, so a full batch
takes BatchNorm's fused kernels. The clip scales the raw gradients before
the optimizer adds Adam's coupled L2 term, the order of mmtpu's optax chain.
The AVMNIST head trains on its plain chain, as in mmtpu; its kernel runs in
the eval forward. UttFusion's two LSTMs run the `lstm` kernel in the train
forward as well (one launch for both), differentiated through the plain
scan's recompute (`ops/lstm.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from mmtpu_torch.models.norm import batch_mask
from mmtpu_torch.train.losses import LossFunctionGroup
from mmtpu_torch.train.state import TrainState


def apply_missing_mask(x: torch.Tensor, mask, invert: bool = False) -> torch.Tensor:
    """x · mask, broadcast over the non-batch axes; mask=None → x.
    `invert=True` gives the complement x · (1 − mask) (mmtpu's
    `{mod}_reverse` inputs), and zeros for mask=None."""
    if mask is None:
        return torch.zeros_like(x) if invert else x
    m = mask.reshape(mask.shape[0], *([1] * (x.dim() - 1))).to(x.dtype)
    return x * ((1.0 - m) if invert else m)


def to_device(batch: Mapping[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """numpy batch → tensors on `device`."""
    return {
        k: torch.from_numpy(np.ascontiguousarray(v)).to(device, non_blocking=True)
        for k, v in batch.items()
    }


def has_padded_rows(batch: Mapping[str, np.ndarray]) -> bool:
    """The host batch has zero-padded tail rows (BatchNorm then needs the
    sample mask; a full batch takes its fused kernels)."""
    mask = batch.get("sample_mask")
    return mask is not None and not np.all(mask > 0)


@dataclasses.dataclass
class ClassificationTask:
    """Multi-input classifier: inputs → logits → loss, predictions.
    `multilabel` (MM-IMDb): int32 predictions sigmoid(logits) >
    `binary_threshold` per label, instead of the argmax."""

    model: torch.nn.Module
    loss_group: LossFunctionGroup
    input_keys: Sequence[str] = ("audio", "image")
    multilabel: bool = False
    binary_threshold: float = 0.5

    def inputs(self, batch: Mapping[str, torch.Tensor]):
        return [apply_missing_mask(batch[k], batch.get(f"{k}_mask")) for k in self.input_keys]

    def apply(self, batch: Mapping[str, torch.Tensor], *, train: bool,
              bn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The forward; `bn_mask` is published to BatchNorm (train mode)."""
        self.model.train(train)
        with batch_mask(bn_mask):
            return self.model(*self.inputs(batch))

    def predictions(self, logits: torch.Tensor) -> torch.Tensor:
        if self.multilabel:
            return (torch.sigmoid(logits) > self.binary_threshold).to(torch.int32)
        return logits.argmax(dim=-1)

    def probabilities(self, logits: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(logits) if self.multilabel else torch.softmax(logits, dim=-1)

    def loss(self, logits, batch, sample_mask=None) -> torch.Tensor:
        return self.loss_group(logits, batch["labels"], sample_mask=sample_mask)["total_loss"]


class MonomodalTask(ClassificationTask):
    """Reads the raw, unmasked modality (monomodal pretraining, as
    mmtpu/cli/train_monomodal.py:186-197)."""

    def inputs(self, batch: Mapping[str, torch.Tensor]):
        return [batch[k] for k in self.input_keys]


def _outputs(task, batch, loss, logits, sample_mask) -> Dict[str, torch.Tensor]:
    out = {"loss": loss, "preds": task.predictions(logits), "labels": batch["labels"]}
    if "pattern_id" in batch:
        out["pattern_id"] = batch["pattern_id"]
    if sample_mask is not None:
        out["sample_mask"] = sample_mask
    return out


def train_step_core(task: ClassificationTask, state: TrainState,
                    batch: Mapping[str, torch.Tensor], padded: bool = True):
    """One gradient step on a batch already on the device. `padded`: the
    batch has padded rows, so BatchNorm gets the sample mask. Returns
    (loss, logits, sample_mask); the loss is detached."""
    sample_mask = batch.get("sample_mask")
    logits = task.apply(batch, train=True, bn_mask=sample_mask if padded else None)
    loss = task.loss(logits, batch, sample_mask=sample_mask)
    apply_gradients(state, loss)
    return loss.detach(), logits.detach(), sample_mask


def apply_gradients(state: TrainState, loss: torch.Tensor) -> None:
    """Backward from `loss`, the optional global-norm clip, the optimizer's
    step: what every train step does once its loss is computed."""
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    # a parameter the loss does not reach (RedCore's AEs) has a gradient of
    # zero in JAX, which the optimizer's L2 term and moments still see
    for p in state.model.parameters():
        if p.grad is None and p.requires_grad:
            p.grad = torch.zeros_like(p)
    if state.clip:
        clip_by_global_norm(state.model.parameters(), state.clip)
    state.optimizer.step()
    state.step += 1


def clip_by_global_norm(params, max_norm: float) -> None:
    """optax.clip_by_global_norm: scale every gradient by max_norm / norm
    when the global norm is at least max_norm."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(factor)


def make_train_step(task: ClassificationTask, state: TrainState,
                    device: torch.device) -> Callable:
    """(numpy batch) → dict of tensors on `device`: loss, preds, labels,
    and pattern_id / sample_mask when the batch has them."""

    def step(batch: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        padded = has_padded_rows(batch)
        batch = to_device(batch, device)
        loss, logits, sample_mask = train_step_core(task, state, batch, padded)
        return _outputs(task, batch, loss, logits, sample_mask)

    return step


def make_eval_step(task: ClassificationTask, device: torch.device) -> Callable:
    """(numpy batch) → dict of tensors on `device`: loss, preds, labels,
    logits, and pattern_id / sample_mask when the batch has them."""

    @torch.inference_mode()
    def step(batch: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        batch = to_device(batch, device)
        logits = task.apply(batch, train=False)
        sample_mask = batch.get("sample_mask")
        loss = task.loss(logits, batch, sample_mask=sample_mask)
        return {**_outputs(task, batch, loss, logits, sample_mask), "logits": logits}

    return step
