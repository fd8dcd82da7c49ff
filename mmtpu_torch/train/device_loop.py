"""The device-resident epoch (counterpart of `mmtpu/train/device_loop.py`).

A split that fits the byte budget is uploaded to the device once, for the
whole run. Each epoch the host then builds only the schedule, sample order,
pattern ids and keep masks, (steps, batch) scalars, and uploads it in one
copy per key at the epoch's start. Every step gathers its batch from the
resident tensors (`index_select`) and runs the same train step as the
streaming path (`train/step.py::train_step_core`), so the two paths compute
the same thing, dropout draws included. Inside the epoch there is no
host↔device copy and no synchronisation: the host already holds the
schedule, so it knows which steps have padded rows and publishes the
BatchNorm sample mask for those only, without reading a device value. The
steps' outputs stay on the device and come to the host once, stacked, at
the epoch's end.

Eval fuses `sub_batches` loader-sized batches into each step (the patterns
× samples product in fewer, larger forwards) and still reduces the loss per
ORIGINAL batch, so the epoch's mean of batch means is the unfused one at any
factor, tail included. `build_schedule` is mmtpu's, bit for bit: the same
seeded shuffle `(seed, epoch, 0x5EED)`, `train_schedule(epoch)`, the eval
product order, and `drop_last` at the base batch before the fused padding.

On a data-parallel mesh (mmtpu's scan-on-mesh) every rank uploads the
whole split and builds the whole schedule, then keeps its rows of every
step (`shard_schedule`); the train step sums the gradients over the ranks,
and the eval's losses are each rank's shares of the global ones, which the
loop sums once the epoch's outputs are gathered.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from mmtpu_torch.modalities import Modality
from mmtpu_torch.train.step import _outputs, on_mesh, output_logits, train_step_core

DEFAULT_BUDGET_BYTES = 4 * 2**30  # 4 GiB of device memory for resident data


def _needed_modalities(dataset):
    """Only the target modality's arrays for a unimodal dataset: the
    streaming loader gathers the same subset."""
    return [
        m for m in dataset.arrays
        if dataset.target_modality in (Modality.MULTIMODAL, m)
    ]


def dataset_nbytes(dataset) -> int:
    return int(
        sum(dataset.arrays[m].nbytes for m in _needed_modalities(dataset))
        + dataset.labels.nbytes
        + sum(
            a.nbytes for a in getattr(dataset, "lengths", {}).values()
            if a is not None
        )
    )


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


@dataclasses.dataclass
class DeviceResidentData:
    arrays: Dict[str, torch.Tensor]
    labels: torch.Tensor
    lengths: Dict[str, torch.Tensor]

    @classmethod
    def upload(cls, dataset, device: torch.device) -> "DeviceResidentData":
        """The split's needed arrays, labels and per-sample lengths on the
        device, so a gathered batch has the streaming loader's keys."""
        needed = _needed_modalities(dataset)
        return cls(
            arrays={str(m): _upload(dataset.arrays[m], device) for m in needed},
            labels=_upload(dataset.labels, device),
            lengths={
                str(m): _upload(a, device)
                for m, a in getattr(dataset, "lengths", {}).items()
                if a is not None and m in needed
            },
        )


def put_schedule(schedule: Dict[str, np.ndarray], device: torch.device
                 ) -> Dict[str, torch.Tensor]:
    """The epoch's schedule on the device: one copy per key."""
    return {k: _upload(v, device) for k, v in schedule.items()}


def gather_batch(data: DeviceResidentData, schedule: Dict[str, torch.Tensor],
                 step: int) -> Dict[str, torch.Tensor]:
    """Step `step`'s batch from the resident tensors, with the streaming
    loader's keys: {mod}, {mod}_lengths, the schedule's keep masks, pattern
    ids and sample mask, labels and sample_idx."""
    idx = schedule["idx"][step]
    batch = {mod: arr.index_select(0, idx) for mod, arr in data.arrays.items()}
    for mod, lens in data.lengths.items():
        batch[f"{mod}_lengths"] = lens.index_select(0, idx)
    for key, val in schedule.items():
        if key != "idx":
            batch[key] = val[step]
    batch["labels"] = data.labels.index_select(0, idx)
    batch["sample_idx"] = idx
    return batch


def padded_steps(schedule: Dict[str, np.ndarray]) -> List[bool]:
    """Per step, whether it has padded rows: read from the host schedule."""
    return [not np.all(row > 0) for row in schedule["sample_mask"]]


def stack_outputs(outs: List[Dict[str, torch.Tensor]]) -> Dict[str, np.ndarray]:
    """The steps' outputs stacked (steps, ...) and copied to the host, once
    per key, at the epoch's end."""
    return {k: torch.stack([o[k] for o in outs]).cpu().numpy() for k in outs[0]}


def run_train_epoch(task, state, data: DeviceResidentData,
                    schedule: Dict[str, np.ndarray], device: torch.device
                    ) -> Dict[str, np.ndarray]:
    """Every step of the schedule through `train_step_core`; the stacked
    (steps, batch) outputs on the host: loss (steps,), preds, labels,
    pattern_id, sample_mask."""
    padded = padded_steps(schedule)
    sched = put_schedule(schedule, device)
    outs = []
    for step, pad in enumerate(padded):
        batch = gather_batch(data, sched, step)
        loss, logits, sample_mask = train_step_core(task, state, batch, pad)
        outs.append(_outputs(task, batch, loss, logits, sample_mask))
    return stack_outputs(outs)


def shard_schedule(schedule: Dict[str, np.ndarray], mesh) -> Dict[str, np.ndarray]:
    """This rank's columns of an epoch's (steps, batch) schedule: its
    contiguous rows of every global batch (mmtpu shards the schedule's
    batch axis over the mesh)."""
    return {k: v[:, mesh.rows(v.shape[1])] for k, v in schedule.items()}


def _sub_batch_rows(batch: int, sub_batches: int, mesh) -> List[slice]:
    """Per ORIGINAL batch of a fused eval step, its rows among this rank's
    (empty where the rank holds none of them); every original batch without
    a mesh."""
    base = batch // sub_batches
    if mesh is None:
        return [slice(j * base, (j + 1) * base) for j in range(sub_batches)]
    own = mesh.rows(batch)
    return [slice(min(max(j * base, own.start), own.stop) - own.start,
                  min(max((j + 1) * base, own.start), own.stop) - own.start)
            for j in range(sub_batches)]


@torch.inference_mode()
def run_eval_epoch(task, data: DeviceResidentData, schedule: Dict[str, np.ndarray],
                   device: torch.device, sub_batches: int = 1, mesh=None
                   ) -> Dict[str, np.ndarray]:
    """The eval forward over the schedule; each step holds `sub_batches`
    original batches, whose losses are reduced one by one, so `loss` is
    (steps, sub_batches) when fused, (steps,) otherwise. Under `mesh` the
    schedule holds this rank's rows and each loss is this rank's share of
    its original batch's global loss (zero where it holds none of its rows):
    the shares sum to the single-device loss."""
    padded = padded_steps(schedule)
    sched = put_schedule(schedule, device)
    outs = []
    for step, pad in enumerate(padded):
        batch = gather_batch(data, sched, step)
        sample_mask = batch["sample_mask"]
        with on_mesh(mesh):
            out = task.apply(batch, train=False, bn_mask=sample_mask if pad else None)
            if sub_batches > 1:
                if isinstance(out, dict):
                    raise NotImplementedError(
                        "fused eval: a model with an auxiliary loss (a dict output) has no "
                        "per-original-batch loss; use --eval-batch-factor 1")
                rows = _sub_batch_rows(out.shape[0] * (mesh.world_size if mesh else 1),
                                       sub_batches, mesh)
                loss = torch.stack([
                    task.loss(out[r], {"labels": batch["labels"][r]},
                              sample_mask=sample_mask[r])
                    for r in rows
                ])
            else:
                loss = task.loss(out, batch, sample_mask=sample_mask)
        outs.append(_outputs(task, batch, loss, output_logits(out), sample_mask))
    return stack_outputs(outs)


def build_schedule(
    dataset, batch_size: int, epoch: int, shuffle: bool, seed: int, split: str,
    drop_last: bool = False, base_batch_size: int = None,
) -> Dict[str, np.ndarray]:
    """Host-side epoch schedule: (steps, batch) index/pattern/mask arrays,
    the streaming loader's order, drop_last included. With eval fusion
    (batch_size = base × factor), drop_last truncates at the BASE batch
    size first, the rows the streaming loader would drop, before the fused
    partition pads the remainder."""
    vocab = dataset.pattern_vocab()
    mods = list(dataset.AVAILABLE_MODALITIES.values())
    if split == "train":
        order = np.arange(dataset.num_samples)
        if shuffle:
            rng = np.random.default_rng((seed, epoch, 0x5EED))
            rng.shuffle(order)
        pattern_of = dataset.train_schedule(epoch)[order]
        sample_idx = order
    else:
        n = dataset.num_samples
        sample_idx = np.tile(np.arange(n), len(vocab))
        pattern_of = np.repeat(np.arange(len(vocab)), n)

    total = sample_idx.shape[0]
    if drop_last:
        base = base_batch_size or batch_size
        total = (total // base) * base
        sample_idx = sample_idx[:total]
        pattern_of = pattern_of[:total]
    steps = -(-total // batch_size)
    padded = steps * batch_size
    pad = padded - total
    sample_mask = np.ones(padded, np.float32)
    if pad:
        sample_idx = np.concatenate([sample_idx, np.zeros(pad, sample_idx.dtype)])
        pattern_of = np.concatenate([pattern_of, np.zeros(pad, pattern_of.dtype)])
        sample_mask[total:] = 0.0

    schedule: Dict[str, np.ndarray] = {
        "idx": sample_idx.reshape(steps, batch_size).astype(np.int32),
        "pattern_id": pattern_of.reshape(steps, batch_size).astype(np.int32),
        "sample_mask": sample_mask.reshape(steps, batch_size),
    }
    for mod in mods:
        if dataset.target_modality not in (Modality.MULTIMODAL, mod):
            continue
        mask = dataset.mask_stack(mod)[pattern_of[:total], sample_idx[:total]]
        mask = np.concatenate([mask, np.zeros(pad, np.float32)]) if pad else mask
        schedule[f"{mod}_mask"] = mask.reshape(steps, batch_size).astype(np.float32)
    return schedule
