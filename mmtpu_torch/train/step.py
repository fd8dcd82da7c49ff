"""Train and eval steps of the port (counterpart of `apply_missing_mask`,
`ClassificationTask`, `train_step_core`, `make_train_step` and
`make_eval_step`, mmtpu/train/step.py). A model may return
{"logits", "aux_loss"} (MulT with its discriminator): the task's loss adds
`aux_loss`, and its predictions and the steps' outputs take the logits.

A missing modality is zeroed in the RAW input before its encoder, by the
batch's `{mod}_mask` — not in the embedding: with BatchNorm running
statistics a zeroed image still gives a non-zero embedding, as in mmtpu.
In the port the model holds its weights, so a step takes only the batch
(and the train step the `TrainState`). Outputs stay on the device: the
loop copies them to the host once per epoch.

The train step runs the train-mode forward with the batch's sample mask
published to BatchNorm (`models/norm.py`; the eval step publishes it too,
for MulT's discriminator loss: BatchNorm in eval mode does not read it),
the padded-row-masked loss,
backward, the optional global-norm clip and `optimizer.step()`. The mask
is published only when the host batch has padded rows, so a full batch
takes BatchNorm's fused kernels. The clip scales the raw gradients before
the optimizer adds Adam's coupled L2 term, the order of mmtpu's optax chain.
The AVMNIST head trains on its plain chain, as in mmtpu; its kernel runs in
the eval forward. UttFusion's two LSTMs run the `lstm` kernel in the train
forward as well (one launch for both), differentiated through the plain
scan's recompute (`ops/lstm.py`).

In a data-parallel rank (`state.mesh`, or the eval step's `mesh`) a step
takes its rows of the global batch and runs under `with mesh:`, so
BatchNorm takes global-batch statistics and the loss is this rank's share
of the global masked mean; `apply_gradients` sums the gradients over the
ranks before the clip (`parallel/mesh.py`). On a mesh with a model axis
the gradients are summed over the data group alone, and the clip's norm
adds the sharded leaves' squares over the model group
(`parallel/tensor.py`).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from mmtpu_torch.models.norm import batch_mask
from mmtpu_torch.parallel.mesh import active_mesh, shard_batch
from mmtpu_torch.parallel.tensor import sharded_parameters
from mmtpu_torch.train.losses import LossFunctionGroup, _masked_reduce
from mmtpu_torch.train.state import TrainState


def apply_missing_mask(x: torch.Tensor, mask, invert: bool = False) -> torch.Tensor:
    """x · mask, broadcast over the non-batch axes; mask=None → x.
    `invert=True` gives the complement x · (1 − mask) (mmtpu's
    `{mod}_reverse` inputs), and zeros for mask=None."""
    if mask is None:
        return torch.zeros_like(x) if invert else x
    m = mask.reshape(mask.shape[0], *([1] * (x.dim() - 1))).to(x.dtype)
    return x * ((1.0 - m) if invert else m)


def masked_mean(per_sample, sample_mask):
    """Mean over the real rows only; the plain mean without a mask (the
    losses' reduction)."""
    return _masked_reduce(per_sample, sample_mask)


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


def rows_on_device(batch: Mapping[str, np.ndarray], mesh, device: torch.device):
    """This rank's rows of the host batch under `mesh` (all of them
    without one) on `device`, and whether those rows have padded ones."""
    if mesh is not None:
        batch = shard_batch(batch, mesh)
    return to_device(batch, device), has_padded_rows(batch)


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

    def predictions(self, logits) -> torch.Tensor:
        logits = output_logits(logits)
        if self.multilabel:
            return (torch.sigmoid(logits) > self.binary_threshold).to(torch.int32)
        return logits.argmax(dim=-1)

    def probabilities(self, logits) -> torch.Tensor:
        logits = output_logits(logits)
        return torch.sigmoid(logits) if self.multilabel else torch.softmax(logits, dim=-1)

    def loss(self, logits, batch, sample_mask=None) -> torch.Tensor:
        aux = logits.get("aux_loss", 0.0) if isinstance(logits, dict) else 0.0
        return self.loss_group(output_logits(logits), batch["labels"],
                               sample_mask=sample_mask)["total_loss"] + aux


def output_logits(out) -> torch.Tensor:
    """The logits of a model's output: a model with an auxiliary head
    (MulT's discriminator) returns {"logits", "aux_loss"}."""
    return out["logits"] if isinstance(out, dict) else out


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


def on_mesh(mesh):
    """`with on_mesh(mesh):` publishes a data-parallel mesh to BatchNorm and
    the losses (`parallel/mesh.py`); None publishes nothing."""
    return contextlib.nullcontext() if mesh is None else mesh


def train_step_core(task: ClassificationTask, state: TrainState,
                    batch: Mapping[str, torch.Tensor], padded: bool = True,
                    grad_hook: Optional[Callable[[torch.nn.Module], None]] = None):
    """One gradient step on a batch already on the device (this rank's rows
    of the global batch under `state.mesh`). `padded`: the batch has padded
    rows, so BatchNorm gets the sample mask. `grad_hook(model)` sees the
    raw gradients (`apply_gradients`). Returns (loss, logits, sample_mask);
    the loss is detached, and under a mesh it is this rank's share of the
    global loss."""
    sample_mask = batch.get("sample_mask")
    with on_mesh(state.mesh):
        logits = task.apply(batch, train=True, bn_mask=sample_mask if padded else None)
        loss = task.loss(logits, batch, sample_mask=sample_mask)
    apply_gradients(state, loss, grad_hook)
    return loss.detach(), output_logits(logits).detach(), sample_mask


def apply_gradients(state: TrainState, loss: torch.Tensor,
                    grad_hook: Optional[Callable[[torch.nn.Module], None]] = None) -> None:
    """Backward from `loss`, the gradients summed over the ranks of
    `state.mesh` (one all-reduce of a flattened bucket), the optional
    global-norm clip, the optimizer's step: what every train step does once
    its loss is computed. `grad_hook(model)`, when given, runs between the
    all-reduce and the clip, where the gradients are the raw global ones
    (the monitor's gradient statistics, as mmtpu takes them before optax's
    clip)."""
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    # a parameter the loss does not reach (RedCore's AEs) has a gradient of
    # zero in JAX, which the optimizer's L2 term and moments still see
    for p in state.model.parameters():
        if p.grad is None and p.requires_grad:
            p.grad = torch.zeros_like(p)
    if state.mesh is not None:
        # each rank's gradient is that of its share of the global loss: the
        # sum is the global gradient, which the clip then sees, as in optax
        state.mesh.all_reduce_grads(state.model.parameters())
    if grad_hook is not None:
        grad_hook(state.model)
    if state.clip:
        with on_mesh(state.mesh):
            shards = sharded_parameters(state.model)
            extra = (shards,) if shards else ()  # a whole model: optax's two arguments
            clip_by_global_norm(state.model.parameters(), state.clip, *extra)
    state.optimizer.step()
    state.step += 1


def clip_by_global_norm(params, max_norm: float, sharded=()) -> None:
    """optax.clip_by_global_norm: scale every gradient by max_norm / norm
    when the global norm is at least max_norm. A parameter of `sharded`
    (split over the model axis, `parallel.tensor.sharded_parameters`) adds
    its shards' squares over the model group of the active mesh, so the
    norm is that of the whole tensors."""
    params = [p for p in params if p.grad is not None]
    grads = [p.grad for p in params]
    split = {id(p) for p in sharded}
    shards = [p.grad for p in params if id(p) in split]
    if shards:
        squares = torch.stack([g.square().sum() for g in shards]).sum()
        whole = [g.square().sum() for p, g in zip(params, grads) if id(p) not in split]
        norm = torch.sqrt(torch.stack(whole).sum() + active_mesh().model_all_reduce_(squares))
    else:
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(factor)


def make_train_step(task: ClassificationTask, state: TrainState,
                    device: torch.device) -> Callable:
    """(numpy batch) → dict of tensors on `device`: loss, preds, labels,
    and pattern_id / sample_mask when the batch has them. Under
    `state.mesh` the step takes this rank's rows of the global batch, and
    its outputs are those rows'. `step(batch, grad_hook=f)` calls `f(model)`
    on the raw gradients (`apply_gradients`)."""

    def step(batch: Mapping[str, np.ndarray], grad_hook=None) -> Dict[str, torch.Tensor]:
        batch, padded = rows_on_device(batch, state.mesh, device)
        loss, logits, sample_mask = train_step_core(task, state, batch, padded, grad_hook)
        return _outputs(task, batch, loss, logits, sample_mask)

    return step


def make_eval_step(task: ClassificationTask, device: torch.device, mesh=None) -> Callable:
    """(numpy batch) → dict of tensors on `device`: loss, preds, labels,
    logits, and pattern_id / sample_mask when the batch has them; under
    `mesh`, this rank's rows and its share of the batch's global loss."""

    @torch.inference_mode()
    def step(batch: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        batch, padded = rows_on_device(batch, mesh, device)
        sample_mask = batch.get("sample_mask")
        with on_mesh(mesh):
            out = task.apply(batch, train=False, bn_mask=sample_mask if padded else None)
            loss = task.loss(out, batch, sample_mask=sample_mask)
        logits = output_logits(out)
        return {**_outputs(task, batch, loss, logits, sample_mask), "logits": logits}

    return step
