"""The epoch loop (counterpart of the streaming path of `TrainLoop`,
mmtpu/train/loop.py).

Train/validate epochs, per-pattern metric recording, the incremental
`epoch_metrics.json` (list-of-epochs schema; `reference` nesting puts
f1_*/MSA_* keys under their pattern, `avmnist` nesting every
pattern-suffixed metric), early stopping, best checkpoints, the host-side
LR scale, the rolling resume point, and the test-time restore of the best
checkpoint. The step's outputs stay on the device until the epoch ends and
are copied to the host once (the recorder's `_materialize`).

With a `monitor` (`monitor.ExperimentMonitor`, mmtpu's `monitor=`) every
split streams, as in mmtpu, and each train epoch runs mmtpu's order:
`start_epoch`; per batch the step, with the gradient statistics taken
between the all-reduce and the clip on the monitor's gradient steps, then
the activation capture (one eval forward of the batch's masked inputs) on
its activation steps, then `step()`; `end_epoch` (the weights) after the
last batch. The monitor is closed at the end of `run`.

The device-resident epoch (`train/device_loop.py`, mmtpu's scan path):
with `device_resident` "auto" (the default) or "on", a loop with the
standard steps (no `step_builders`, no `record_fn`) uploads each split
that fits once, train first, then validation, then the rest, against ONE
cumulative budget ("auto"; "on" admits every split), and runs its epochs
from the device; a split that does not fit streams. Eval on the resident
path fuses `eval_batch_factor` loader batches per step (None: grow toward
1024 rows, at most 8, `_auto_eval_factor`), with the same results. A loop
with a monitor never uploads.

On a data-parallel mesh (`mesh=`, a launched `parallel.mesh.Mesh`, as
mmtpu's `mesh=`): the model starts from rank 0's weights; every step takes
this rank's rows of the global batch and sums its gradients over the
ranks; a split is resident only when the mesh divides its batch, and then
every rank uploads all of it and keeps its rows of each step (mmtpu's
scan-on-mesh). Under a monitor rank 0 records: its gradients are the
all-reduced ones, and it captures the activations of the whole global
batch, which every rank's loader holds, outside the mesh (the eval forward
takes no collective); the others keep the cadence. At each epoch's end the outputs are gathered into the
global batches' over the host group and the losses' shares summed, so the
recorder, early stopping, the scheduler and the best checkpoint see and
decide what one device does. Rank 0 alone writes (checkpoints, the JSON
records, `on_best`), with every rank's RNG states in the rolling resume
point; the others wait at a barrier before they read a checkpoint.

For other training tasks (C-MAM), as in mmtpu: `step_builders` replaces the
train and eval step factories, `record_fn(recorder, out, vocab)` the
recording of a step's outputs, and a step that returns `terms` (a dict of
loss terms) gets their per-epoch means, 'total_loss' left out, added to
the validation and test metrics. `metrics_history_nested` and
`test_metrics_nested` keep each record as the recorder's group dicts plus
`loss` (and those term means on validation and test), the records C-MAM's
report writes.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import re
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from mmtpu_torch.checkpoints.manager import CheckpointManager, rng_state
from mmtpu_torch.parallel.mesh import replicate
from mmtpu_torch.train.device_loop import stack_outputs
from mmtpu_torch.train.early_stopping import EarlyStopping
from mmtpu_torch.train.optim import LRController, set_lr_scale
from mmtpu_torch.train.recorder import MetricRecorder
from mmtpu_torch.train.state import TrainState
from mmtpu_torch.train.step import apply_missing_mask, make_eval_step, make_train_step, to_device
from mmtpu_torch.utils import flatten_leaves

logger = logging.getLogger(__name__)


def _nest_epoch_metrics(flat: Dict[str, Any], style: str = "reference") -> Dict[str, Any]:
    """The reference's JSON nesting: f1_*/MSA_* keys under their pattern;
    style='avmnist' nests every pattern-suffixed metric under its pattern.
    As in mmtpu, the MSA pattern is parts[3] (right for 4-part keys only)."""
    out: Dict[str, Any] = {}
    for key, value in flat.items():
        if key == "loss" or not isinstance(value, (int, float)):
            continue
        parts = key.split("_")
        if key.startswith("MSA_") and len(parts) >= 4:
            out.setdefault(parts[3], {})["_".join(parts[:3])] = value
        elif key.startswith("f1_") and len(parts) >= 3:
            out.setdefault(parts[2], {})["_".join(parts[:2])] = value
        elif style == "avmnist" and parts[-1].isupper() and 1 <= len(parts[-1]) <= 4:
            out.setdefault(parts[-1], {})["_".join(parts[:-1])] = value
        else:
            out.setdefault("metrics", {})[key] = value
    return out


def split_epoch_entry(loss: float, metrics: Dict[str, Any], elapsed: float,
                      n_batches: int, json_nesting: str) -> Dict[str, Any]:
    """One split's body in an epoch_metrics.json entry."""
    return {
        "loss": loss,
        "timing": {"total_time": elapsed, "avg_batch_time": elapsed / max(int(n_batches), 1)},
        **_nest_epoch_metrics(metrics, json_nesting),
    }


def resolve_save_target(val_metrics: Dict[str, Any], save_metric: str) -> float:
    """Best-checkpoint target from the flattened validation metrics: the
    metric itself, else `{metric}_{PATTERN}` with the longest pattern;
    raises when there is none."""
    target = val_metrics.get(save_metric)
    if target is not None:
        return float(target)
    rx = re.compile(rf"^{re.escape(save_metric)}(_[A-Z0-9]+)?$")
    cands = [k for k in val_metrics if rx.match(k) and isinstance(val_metrics[k], (int, float))]
    if cands:
        return float(val_metrics[max(cands, key=len)])
    available = sorted(k for k, v in val_metrics.items() if isinstance(v, (int, float)))
    raise ValueError(f"save_metric {save_metric!r} not found in validation metrics. "
                     f"Available: {available}")


def _auto_eval_factor(batch_size: int, eval_total: int, target_rows: int = 1024) -> int:
    """Fused-eval batch factor: grow the rows per step toward `target_rows`
    without exceeding the epoch, at most 8×."""
    if batch_size <= 0:
        return 1
    factor = max(1, min(8, target_rows // batch_size))
    steps = -(-eval_total // batch_size)
    return max(1, min(factor, steps))


@dataclasses.dataclass
class ResidentSplit:
    """A split on the resident path: its data on the device, its loader
    (the dataset, batch and order settings the schedule follows), and the
    loader batches fused into each step."""

    data: Any
    loader: Any
    sub_batches: int

    @property
    def batch_size(self) -> int:
        return self.loader.batch_size * self.sub_batches


def _jsonable(obj: Any) -> Any:
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return obj


def gather_epoch(mesh, outs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """An epoch's (steps, rows, ...) outputs of every rank of `mesh`, in
    global-batch order, on every rank (one gather over the host group); the
    losses, each rank's share of the global ones, summed."""
    parts = mesh.gather(outs)
    return {k: (np.sum([p[k] for p in parts], axis=0) if k == "loss"
                else np.concatenate([p[k] for p in parts], axis=1)) for k in outs}


def gathered_steps(mesh, outs: List[Dict[str, Any]]) -> List[Dict[str, torch.Tensor]]:
    """The outputs of an epoch's streaming steps on every rank of `mesh`,
    step by step in global-batch order (`gather_epoch`); what is not a
    tensor (a step's loss-term dict) is left out."""
    host = gather_epoch(mesh, stack_outputs(
        [{k: v for k, v in out.items() if isinstance(v, torch.Tensor)} for out in outs]))
    return [{k: torch.as_tensor(v[i]) for k, v in host.items()} for i in range(len(outs))]


class TrainLoop:
    def __init__(
        self,
        *,
        task,
        state: TrainState,
        loaders: Dict[str, Any],
        recorder: MetricRecorder,
        checkpoint_manager: CheckpointManager,
        device: torch.device,
        epochs: int,
        save_metric: str = "loss",
        early_stopping: Optional[EarlyStopping] = None,
        lr_controller: Optional[LRController] = None,
        metrics_path: Optional[Path] = None,
        group_name: str = "classification",
        on_best: Optional[Callable[[TrainState, int], None]] = None,
        print_interval: int = 1,
        json_nesting: str = "reference",
        run_id: Optional[int] = None,
        vocab_override: Optional[List[str]] = None,
        metrics_postprocess: Optional[Callable[[Dict[str, Any]], Dict[str, Any]]] = None,
        resume: bool = False,
        record_fn: Optional[Callable] = None,
        step_builders: Optional[Tuple[Callable, Callable]] = None,
        device_resident: str = "auto",
        eval_batch_factor: Optional[int] = None,
        mesh=None,
        monitor=None,
    ) -> None:
        # vocab_override renames the recorder's pattern vocabulary (the
        # monomodal entry point records under the MODALITY name);
        # metrics_postprocess runs over each epoch's flattened metrics
        self.task = task
        self.state = state
        self.loaders = loaders
        self.recorder = recorder
        self.ckpt = checkpoint_manager
        self.device = device
        self.epochs = epochs
        self.save_metric = save_metric
        self.early = early_stopping or EarlyStopping(enabled=False)
        self.lr = lr_controller
        self.metrics_path = Path(metrics_path) if metrics_path else None
        self.group_name = group_name
        self.on_best = on_best
        self.print_interval = print_interval
        self.json_nesting = json_nesting
        self.run_id = run_id
        self.vocab_override = vocab_override
        self.metrics_postprocess = metrics_postprocess
        self.resume = resume
        # a data-parallel rank: the state starts from rank 0's weights and
        # its steps sum their gradients over the mesh (mmtpu replicates the
        # state onto the mesh here)
        self.mesh = mesh
        if mesh is not None:
            replicate(state.model, mesh)
            state.mesh = mesh
        # step_builders: (make_train(task, state, device), make_eval(task, device, mesh))
        if monitor is not None and step_builders is not None:
            raise ValueError("the monitor records the standard train step's gradients; "
                             "a loop with step_builders takes none, as in mmtpu")
        self.monitor = monitor
        make_train, make_eval = step_builders or (make_train_step, make_eval_step)
        self.train_step = make_train(task, state, device)
        self.eval_step = make_eval(task, device, mesh)
        self._record = record_fn or self._default_record
        self.epoch_metrics: List[Dict[str, Any]] = []
        self.timing_history: Dict[str, List[float]] = {"train": [], "validation": []}
        self.metrics_history: Dict[str, List[Dict[str, Any]]] = {"train": [], "validation": []}
        self.metrics_history_nested: Dict[str, List[Dict[str, Any]]] = {
            "train": [], "validation": []}
        self.test_metrics_nested: Dict[str, Dict[str, Any]] = {}
        self._phase_terms: List[Dict[str, torch.Tensor]] = []
        self._resident: Dict[str, ResidentSplit] = {}
        if (device_resident in ("auto", "on") and step_builders is None
                and record_fn is None and monitor is None):
            self._admit(device_resident, eval_batch_factor)

    def _admit(self, mode: str, eval_batch_factor: Optional[int]) -> None:
        """Upload the splits that fit. "auto" budgets the CUMULATIVE bytes
        (every admitted split stays on the device for the whole run): train
        first, it runs every epoch, then validation, then the rest."""
        from mmtpu_torch.train import device_loop as dl

        remaining = dl.DEFAULT_BUDGET_BYTES
        priority = {"train": 0, "validation": 1}
        dp = self.mesh.world_size if self.mesh is not None else 1
        for split, loader in sorted(self.loaders.items(),
                                    key=lambda kv: priority.get(kv[0], 2)):
            ds = getattr(loader, "dataset", None)
            if ds is None or not getattr(ds, "arrays", None):
                continue
            if mode == "auto":
                nbytes = dl.dataset_nbytes(ds)
                if nbytes > remaining:
                    continue
                remaining -= nbytes
            if loader.batch_size % dp:
                continue  # batch not shardable over the data axis: it streams
            if split == "train":
                factor = 1
            elif eval_batch_factor is None:
                factor = _auto_eval_factor(loader.batch_size,
                                           ds.num_samples * len(ds.pattern_vocab()))
            else:
                factor = max(1, int(eval_batch_factor))
            self._resident[split] = ResidentSplit(
                dl.DeviceResidentData.upload(ds, self.device), loader, factor)

    # -- epochs -----------------------------------------------------------------

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _vocab(self, vocab: List[str]) -> List[str]:
        if self.vocab_override is not None and len(self.vocab_override) == len(vocab):
            return self.vocab_override
        return vocab

    def _default_record(self, recorder: MetricRecorder, out: Dict[str, torch.Tensor],
                        vocab: List[str]) -> None:
        pattern_id = out.get("pattern_id")
        if pattern_id is None:
            pattern_id = torch.zeros_like(out["preds"], dtype=torch.int32)
        recorder.update_group_ids(self.group_name, out["preds"], out["labels"],
                                  pattern_id, self._vocab(vocab), out.get("sample_mask"))

    def _epoch(self, split: str, step: Callable) -> float:
        """Run `step` over the split's batches; the mean of the per-batch
        losses, read once at the end. On a mesh the steps' outputs are
        gathered at the end into the global batches', which the recorder
        then reads batch by batch, as on one device."""
        loader = self.loaders[split]
        vocab = loader.pattern_vocab
        losses, outs = [], []
        t0 = time.time()
        for batch in loader:
            out = step(batch)
            losses.append(out["loss"])
            if "terms" in out:
                self._phase_terms.append(out["terms"])
            if self.mesh is None:
                self._record(self.recorder, out, vocab)
            else:
                outs.append(out)
        if outs:
            outs = gathered_steps(self.mesh, outs)
            for out in outs:
                self._record(self.recorder, out, vocab)
            losses = [out["loss"] for out in outs]
        self._sync()
        if split in self.timing_history:
            self.timing_history[split].append(time.time() - t0)
        return float(torch.stack(losses).float().mean().item()) if losses else 0.0

    def _resident_epoch(self, split: str, epoch: int) -> float:
        """The device-resident path: the epoch's schedule keyed by the
        epoch index (the streaming loader counts epochs from 0), the outputs
        on the host once, the recorder fed from them flattened; the loss is
        the mean over the (original) batches with a real row."""
        from mmtpu_torch.train import device_loop as dl

        rs = self._resident[split]
        loader, ds = rs.loader, rs.loader.dataset
        t0 = time.time()
        schedule = dl.build_schedule(ds, rs.batch_size, max(epoch - 1, 0), loader.shuffle,
                                     loader.seed, ds.split, drop_last=loader.drop_last,
                                     base_batch_size=loader.batch_size)
        if self.mesh is not None:
            schedule = dl.shard_schedule(schedule, self.mesh)
        if split == "train":
            outs = dl.run_train_epoch(self.task, self.state, rs.data, schedule, self.device)
        else:
            outs = dl.run_eval_epoch(self.task, rs.data, schedule, self.device, rs.sub_batches,
                                     self.mesh)
        if self.mesh is not None:
            outs = gather_epoch(self.mesh, outs)
        if split in self.timing_history:
            self.timing_history[split].append(time.time() - t0)
        flat = {k: v.reshape((-1,) + v.shape[2:]) for k, v in outs.items() if k != "loss"}
        self.recorder.update_group_ids(self.group_name, flat["preds"], flat["labels"],
                                       flat["pattern_id"], self._vocab(ds.pattern_vocab()),
                                       flat["sample_mask"])
        loss = outs["loss"].reshape(-1)
        live = outs["sample_mask"].reshape(loss.shape[0], -1).max(axis=1) > 0
        return float(np.sum(np.where(live, loss, 0.0)) / max(np.sum(live), 1))

    def train_epoch(self, epoch: int) -> float:
        if "train" in self._resident:
            return self._resident_epoch("train", epoch)
        if self.monitor is None:
            return self._epoch("train", self.train_step)
        self.monitor.start_epoch(epoch)
        loss = self._epoch("train", self._monitored_step)
        self.monitor.end_epoch(self.state.model)
        return loss

    def _monitored_step(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """A train step under the monitor (mmtpu's order): the gradient
        statistics inside the step, then the activation capture, then the
        monitor's step counter."""
        mon = self.monitor
        hook = mon.record_gradients if mon.writes and mon.want_gradients else None
        out = self.train_step(batch, grad_hook=hook)
        if mon.writes and mon.want_activations:
            keys = self.task.input_keys
            host = {k: batch[k] for k in keys}
            host.update({f"{k}_mask": batch[f"{k}_mask"] for k in keys if f"{k}_mask" in batch})
            dev = to_device(host, self.device)
            mon.record_activations(self.task.model, [
                apply_missing_mask(dev[k], dev.get(f"{k}_mask")) for k in keys])
        mon.step()
        return out

    def eval_epoch(self, split: str) -> float:
        if split in self._resident:
            return self._resident_epoch(split, 0)
        return self._epoch(split, self.eval_step)

    def _metrics(self, raw: Dict[str, Dict[str, Any]], loss: float,
                 terms: Optional[Dict[str, float]] = None) -> Dict[str, Any]:
        """The recorder's flattened results with the loss and the term
        means, post-processed."""
        metrics = flatten_leaves(raw)
        metrics["loss"] = loss
        metrics.update(terms or {})
        if self.metrics_postprocess is not None:
            metrics = self.metrics_postprocess(metrics)
        return metrics

    def _drain_terms(self) -> Dict[str, float]:
        """Per-epoch means of the steps' loss terms, 'total_loss' left out
        (the reference's val_loss_info), in sorted key order as mmtpu's come
        back from its jitted steps; one device→host copy per term."""
        terms, self._phase_terms = self._phase_terms, []
        if not terms:
            return {}
        return {k: float(np.mean(torch.stack([t[k] for t in terms]).cpu().numpy()))
                for k in sorted(terms[0]) if k != "total_loss"}

    # -- mid-run resume -----------------------------------------------------------

    @property
    def writes(self) -> bool:
        """This process writes the run's files: always on one device, rank 0
        alone on a mesh (every rank computes the same metrics and decisions)."""
        return self.mesh is None or self.mesh.is_writer

    def _save_resume_point(self, epoch: int, best_metrics: Optional[Dict[str, Any]]) -> None:
        """Rolling last.pth + the loop's host-side state, every epoch; on a
        mesh rank 0 writes it with every rank's RNG states."""
        rng = self.mesh.gather(rng_state(self.state)) if self.mesh is not None else None
        if not self.writes:
            return
        lr = self.lr
        self.ckpt.save_rolling(self.state, epoch, rng=rng, meta=_jsonable({
            "early": {"best": self.early.best, "counter": self.early.counter,
                      "should_stop": self.early.should_stop},
            "lr": ({"epoch": lr.epoch, "best": lr._best, "num_bad": lr._num_bad,
                    "cooldown": lr._cooldown, "scale": lr._scale} if lr is not None else None),
            "best_metrics": best_metrics,
            "metrics_history": self.metrics_history,
            "metrics_history_nested": self.metrics_history_nested,
            "timing_history": self.timing_history,
        }))

    def _try_resume(self):
        """Restore loop and train state from the rolling resume point.
        Returns (next_epoch, best_metrics), or None without one. The
        loaders' epoch counters are fast-forwarded, so the shuffle and the
        pattern draws of epoch N match the uninterrupted run's; the RNG
        states (dropout) restore from the checkpoint."""
        if self.mesh is not None:
            self.mesh.barrier()
        meta = self.ckpt.load_resume_meta()
        if meta is None:
            return None
        self.ckpt.load_checkpoint(self.state, "last",
                                  rank=self.mesh.rank if self.mesh is not None else None)
        epoch = int(meta["epoch"])
        for loader in self.loaders.values():
            loader.epoch = epoch
        early = meta.get("early") or {}
        self.early.best = early.get("best")
        self.early.counter = int(early.get("counter", 0))
        self.early.should_stop = bool(early.get("should_stop", False))
        lr_meta = meta.get("lr")
        if self.lr is not None and lr_meta:
            self.lr.epoch = int(lr_meta.get("epoch", 0))
            self.lr._best = lr_meta.get("best")
            self.lr._num_bad = int(lr_meta.get("num_bad", 0))
            self.lr._cooldown = int(lr_meta.get("cooldown", 0))
            self.lr._scale = float(lr_meta.get("scale", 1.0))
            set_lr_scale(self.state.optimizer, self.lr._scale)
        self.metrics_history = meta.get("metrics_history", self.metrics_history)
        self.metrics_history_nested = meta.get("metrics_history_nested",
                                               self.metrics_history_nested)
        self.timing_history = meta.get("timing_history", self.timing_history)
        if self.metrics_path is not None:
            fp = self.metrics_path / "epoch_metrics.json"
            if fp.exists():
                # drop entries newer than the resume point and a trailing
                # test entry: the resumed run appends them again
                self.epoch_metrics = [
                    e for e in json.loads(fp.read_text())
                    if isinstance(e, dict) and "epoch" in e and int(e["epoch"]) <= epoch
                ]
        logger.info(f"resuming from epoch {epoch} ({self.ckpt.model_dir})")
        print(f"resuming from epoch {epoch}", flush=True)
        return epoch + 1, meta.get("best_metrics")

    # -- run ----------------------------------------------------------------------

    def run(self) -> Dict[str, Any]:
        try:
            return self._run()
        finally:
            if self.monitor is not None:
                self.monitor.close()

    def _run(self) -> Dict[str, Any]:
        best_metrics: Optional[Dict[str, Any]] = None
        start_epoch = 1
        if self.resume:
            resumed = self._try_resume()
            if resumed is not None:
                start_epoch, best_metrics = resumed
                if self.early.should_stop:
                    return best_metrics or {}
        for epoch in range(start_epoch, self.epochs + 1):
            self.recorder.reset()
            train_loss = self.train_epoch(epoch)
            raw_train = self.recorder.calculate_all_groups(epoch=epoch, loss=train_loss)
            train_metrics = self._metrics(raw_train, train_loss)
            self.metrics_history["train"].append(dict(train_metrics))
            self._drain_terms()  # train records carry no term means, as in mmtpu
            self.metrics_history_nested["train"].append({**raw_train, "loss": train_loss})

            self.recorder.reset()
            val_loss = self.eval_epoch("validation")
            raw_val = self.recorder.calculate_all_groups(epoch=epoch, loss=val_loss)
            val_terms = self._drain_terms()
            val_metrics = self._metrics(raw_val, val_loss, val_terms)
            self.metrics_history["validation"].append(dict(val_metrics))
            self.metrics_history_nested["validation"].append(
                {**raw_val, "loss": val_loss, **val_terms})

            self.epoch_metrics.append({
                "epoch": epoch,
                "train": split_epoch_entry(
                    train_loss, train_metrics, self.timing_history["train"][-1],
                    max(len(self.loaders["train"]), 1), self.json_nesting),
                "validation": split_epoch_entry(
                    val_loss, val_metrics, self.timing_history["validation"][-1],
                    max(len(self.loaders["validation"]), 1), self.json_nesting),
            })
            self._write_epoch_metrics()
            if epoch % self.print_interval == 0:
                print(f"epoch {epoch}/{self.epochs} — train loss {train_loss:.4f}, "
                      f"val loss {val_loss:.4f}", flush=True)

            target = resolve_save_target(val_metrics, self.save_metric)
            if self.early.step(float(target)):
                best_metrics = dict(val_metrics)
                if self.writes:
                    self.ckpt.save_checkpoint(self.state, epoch, float(target))
                    if self.on_best is not None:
                        self.on_best(self.state, epoch)
            if self.early.should_stop:
                print(f"early stopping at epoch {epoch}", flush=True)
                self._save_resume_point(epoch, best_metrics)
                break
            if self.lr is not None:
                scale = self.lr.step(val_loss if self.lr.kind == "plateau" else None)
                set_lr_scale(self.state.optimizer, scale)
            self._save_resume_point(epoch, best_metrics)
        return best_metrics or {}

    def test(self, splits=("test",)) -> Dict[str, Dict[str, Any]]:
        """Restore the best checkpoint and evaluate `splits`. Writes
        `{split}_metrics.json` (the reference's records schema) and the test
        entry: appended to epoch_metrics.json in `reference` nesting, to
        `<metrics>/<run_id>/epoch_metrics.json` in `avmnist` nesting."""
        from mmtpu_torch.reports import MetricsReport

        if self.mesh is not None:
            self.mesh.barrier()  # rank 0 wrote the best checkpoint
        try:
            self.ckpt.load_checkpoint(self.state, "best")
        except FileNotFoundError:
            logger.warning("no best checkpoint — testing the current weights")
        results = {}
        for split in splits:
            if split not in self.loaders:
                continue
            self.recorder.reset()
            t0 = time.time()
            loss = self.eval_epoch(split)
            elapsed = time.time() - t0
            raw = self.recorder.calculate_all_groups(loss=loss, skip_tensorboard=True)
            terms = self._drain_terms()
            metrics = self._metrics(raw, loss, terms)
            results[split] = metrics
            self.test_metrics_nested[split] = {**raw, "loss": loss, **terms}
            if self.metrics_path is None or not self.writes:
                continue
            MetricsReport(self.metrics_path).generate({}, {split: metrics})
            if split != "test":
                continue
            entry = {"test": split_epoch_entry(loss, metrics, elapsed,
                                               len(self.loaders[split]), self.json_nesting)}
            if self.json_nesting == "reference":
                # the reference's test entry has no 'metrics' bucket
                entry["test"].pop("metrics", None)
                self.epoch_metrics.append(entry)
                self._write_epoch_metrics()
            else:
                sub = self.metrics_path / str(self.run_id if self.run_id is not None else 1)
                sub.mkdir(parents=True, exist_ok=True)
                fp = sub / "epoch_metrics.json"
                data = json.loads(fp.read_text()) if fp.exists() else []
                data.append(entry)
                fp.write_text(json.dumps(_jsonable(data), indent=4))
        return results

    def _write_epoch_metrics(self) -> None:
        if self.metrics_path is None or not self.writes:
            return
        self.metrics_path.mkdir(parents=True, exist_ok=True)
        (self.metrics_path / "epoch_metrics.json").write_text(
            json.dumps(_jsonable(self.epoch_metrics), indent=4))
