"""RedCore train and eval steps with the adaptive β schedule (counterpart
of mmtpu/train/redcore_step.py).

    loss = CE(logits) + CE(logits_A) + CE(logits_V) + CE(logits_T)   (×'cross_entropy')
         + Σ_m KLD_m + 'mse' · Σ_m β_m · MSE_m

- the CEs are masked means over real rows;
- KLD_m = −λ₁ · Σ (1 + logσ² − μ² − exp logσ²) · index_m / B, with B the
  real row count (mmtpu's: the reference's ragged batches have no padding);
- MSE_m = Σ ((gen_m − feature_m) · index_m)² / (B · width) / max(Σ index_m, 1):
  the reference's full-batch mean divided again by the present count, a
  faithful quirk, each modality by its own count.

After the step the schedule (`RedCoreSchedState`) moves on the device: the
per-modality EMA of the MSEs; η × `eta_ext` when `iter_count % 500 == 0`,
so at step 0 too; every `interval_i` steps β ← normalise(max(β·η·ra, 0.1))
with ra = (avg − total)/avg of the EMA, identically −2 whenever the EMA
is positive, so β settles at [1/√3]·3 (the reference's own arithmetic).
The eval step's loss is the fused CE alone.

The train step keeps the schedule in its closure (`RedCoreTrainStep.sched`);
it is not checkpointed, as in mmtpu. The VAE samples and the transformer
dropouts draw from the run's generator (`models/rng.py`).

In a data-parallel rank (`state.mesh`, or the eval step's `mesh`) a step
takes its rows of the global batch and runs under `with mesh:`: B and each
Σ index_m are the global batch's counts, so every term is this rank's
share of the global one, and the MSEs that drive the schedule are the
shares summed over the ranks: every rank advances the same β, EMA and η.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from mmtpu_torch.models.norm import batch_mask
from mmtpu_torch.parallel.mesh import active_mesh
from mmtpu_torch.train.losses import LossFunctionGroup, global_count
from mmtpu_torch.train.mmin_step import MODS, loss_weight, masked, masked_ce
from mmtpu_torch.train.state import TrainState
from mmtpu_torch.train.step import apply_gradients, on_mesh, rows_on_device


@dataclasses.dataclass
class RedCoreSchedState:
    loss_ema: torch.Tensor    # (3,) per-modality EMA of the MSEs
    beta: torch.Tensor        # (3,)
    eta: torch.Tensor         # scalar
    iter_count: torch.Tensor  # scalar int

    @classmethod
    def create(cls, eta: float = 0.001, device: Optional[torch.device] = None
               ) -> "RedCoreSchedState":
        return cls(loss_ema=torch.zeros(3, device=device),
                   beta=torch.ones(3, device=device),
                   eta=torch.tensor(eta, dtype=torch.float32, device=device),
                   iter_count=torch.zeros((), dtype=torch.int32, device=device))


@dataclasses.dataclass
class RedCoreTask:
    model: nn.Module
    loss_group: LossFunctionGroup
    loss_beta: float = 0.95
    interval_i: int = 2
    eta_ext: float = 1.5
    lambda_one: float = 0.0008
    label_key: str = "labels"

    def indices(self, batch):
        """Each modality's missing index (1 = present); ones without a mask."""
        ones = torch.ones(batch[self.label_key].shape[0], device=batch[self.label_key].device)
        return [batch.get(f"{m}_mask", ones) for m in MODS]

    def apply(self, batch, *, train: bool, bn_mask=None) -> Dict[str, torch.Tensor]:
        self.model.train(train)
        with batch_mask(bn_mask):
            return self.model(*(masked(batch, m) for m in MODS), *self.indices(batch))


def redcore_loss(task: RedCoreTask, res, batch, beta: torch.Tensor):
    """The total loss and the (3,) per-modality MSEs (detached; the global
    batch's under a mesh)."""
    iA, iV, iT = task.indices(batch)
    labels = batch[task.label_key]
    sm = batch.get("sample_mask")
    mesh = active_mesh()
    if sm is None:
        B = iA.shape[0] * (1 if mesh is None else mesh.data_size)
    else:
        B = torch.clamp(global_count(sm), min=1.0)
    ce_w = loss_weight(task.loss_group, "cross_entropy")
    ce, ce_A, ce_V, ce_T = (ce_w * masked_ce(res[k], labels, sm)
                            for k in ("logits", "logits_A", "logits_V", "logits_T"))

    def kld(mu, lv, idx):
        return -task.lambda_one * torch.sum((1.0 + lv - mu ** 2 - torch.exp(lv))
                                            * idx[:, None]) / B

    def masked_mse(gen, feat, idx):
        diff = (gen - feat) * idx[:, None]
        return torch.sum(diff ** 2) / (B * gen.shape[-1]) / torch.clamp(global_count(idx),
                                                                       min=1.0)

    index = dict(zip("AVT", (iA, iV, iT)))
    klds = [kld(res[f"fmu_{m}"], res[f"flog_var_{m}"], index[m]) for m in "AVT"]
    mses = [masked_mse(res[f"gen_{m}"], res[f"feature_{m}_miss"], index[m]) for m in "AVT"]
    loss_mse = loss_weight(task.loss_group, "mse") * (
        beta[0] * mses[0] + beta[1] * mses[1] + beta[2] * mses[2])
    total = ce + (klds[0] + klds[1] + klds[2]) + ce_A + ce_V + ce_T + loss_mse
    mses = torch.stack(mses).detach()
    return total, mses if mesh is None else mesh.all_reduce_(mses)


def advance_schedule(task: RedCoreTask, sched: RedCoreSchedState,
                     mses: torch.Tensor) -> RedCoreSchedState:
    """The schedule after a step (mmtpu's on-device update, kept bit for bit)."""
    b = task.loss_beta
    upd = torch.where(mses != 0.0, mses, sched.loss_ema)
    ema = (1.0 - b) * sched.loss_ema + b * upd
    eta = torch.where(sched.iter_count % 500 == 0, sched.eta * task.eta_ext, sched.eta)
    total3 = ema.sum()
    avg3 = total3 / 3.0
    ra = (avg3 - total3) / torch.clamp(avg3, min=1e-12)
    nb = torch.clamp(sched.beta * eta * ra, min=0.1)
    beta = torch.where(sched.iter_count % task.interval_i == 0, nb / torch.linalg.norm(nb),
                       sched.beta)
    return RedCoreSchedState(loss_ema=ema, beta=beta, eta=eta,
                             iter_count=sched.iter_count + 1)


def _outputs(task: RedCoreTask, batch, loss, logits) -> Dict[str, torch.Tensor]:
    out = {"loss": loss, "preds": logits.argmax(dim=-1), "labels": batch[task.label_key]}
    for key in ("pattern_id", "sample_mask"):
        if key in batch:
            out[key] = batch[key]
    return out


class RedCoreTrainStep:
    """(numpy batch) → dict of tensors on the device: loss, preds, labels,
    and pattern_id / sample_mask. `sched` holds the schedule."""

    def __init__(self, task: RedCoreTask, state: TrainState, device: torch.device,
                 sched: Optional[RedCoreSchedState] = None) -> None:
        self.task, self.state, self.device = task, state, device
        self.sched = sched or RedCoreSchedState.create(device=device)

    def core(self, batch, padded: bool = True):
        """One step on a batch on the device; returns (loss, logits), detached."""
        sm = batch.get("sample_mask")
        with on_mesh(self.state.mesh):
            res = self.task.apply(batch, train=True, bn_mask=sm if padded else None)
            loss, mses = redcore_loss(self.task, res, batch, self.sched.beta)
        apply_gradients(self.state, loss)
        self.sched = advance_schedule(self.task, self.sched, mses)
        return loss.detach(), res["logits"].detach()

    def __call__(self, batch: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        batch, padded = rows_on_device(batch, self.state.mesh, self.device)
        loss, logits = self.core(batch, padded)
        return _outputs(self.task, batch, loss, logits)


def make_redcore_eval_step(task: RedCoreTask, device: torch.device, mesh=None):
    @torch.inference_mode()
    def step(batch: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        batch, _ = rows_on_device(batch, mesh, device)
        with on_mesh(mesh):
            res = task.apply(batch, train=False)
            loss = masked_ce(res["logits"], batch[task.label_key], batch.get("sample_mask"))
        return _outputs(task, batch, loss, res["logits"])

    return step
