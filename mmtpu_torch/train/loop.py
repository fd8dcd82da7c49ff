"""The epoch loop (counterpart of the streaming path of `TrainLoop`,
mmtpu/train/loop.py).

Train/validate epochs, per-pattern metric recording, the incremental
`epoch_metrics.json` (list-of-epochs schema; `reference` nesting puts
f1_*/MSA_* keys under their pattern, `avmnist` nesting every
pattern-suffixed metric), early stopping, best checkpoints, the host-side
LR scale, the rolling resume point, and the test-time restore of the best
checkpoint. The step's outputs stay on the device until the epoch ends and
are copied to the host once (the recorder's `_materialize`). mmtpu's
device-resident scan (and with it `--eval-batch-factor`'s fused eval) and
the monitor are not ported.
"""

from __future__ import annotations

import json
import logging
import re
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from mmtpu_torch.checkpoints.manager import CheckpointManager
from mmtpu_torch.train.early_stopping import EarlyStopping
from mmtpu_torch.train.optim import LRController, set_lr_scale
from mmtpu_torch.train.recorder import MetricRecorder
from mmtpu_torch.train.state import TrainState
from mmtpu_torch.train.step import make_eval_step, make_train_step
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
        self.train_step = make_train_step(task, state, device)
        self.eval_step = make_eval_step(task, device)
        self.epoch_metrics: List[Dict[str, Any]] = []
        self.timing_history: Dict[str, List[float]] = {"train": [], "validation": []}
        self.metrics_history: Dict[str, List[Dict[str, Any]]] = {"train": [], "validation": []}

    # -- epochs -----------------------------------------------------------------

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _vocab(self, vocab: List[str]) -> List[str]:
        if self.vocab_override is not None and len(self.vocab_override) == len(vocab):
            return self.vocab_override
        return vocab

    def _record(self, out: Dict[str, torch.Tensor], vocab: List[str]) -> None:
        pattern_id = out.get("pattern_id")
        if pattern_id is None:
            pattern_id = torch.zeros_like(out["preds"], dtype=torch.int32)
        self.recorder.update_group_ids(self.group_name, out["preds"], out["labels"],
                                       pattern_id, self._vocab(vocab), out.get("sample_mask"))

    def _epoch(self, split: str, step: Callable) -> float:
        """Run `step` over the split's batches; the mean of the per-batch
        losses, read once at the end."""
        loader = self.loaders[split]
        vocab = loader.pattern_vocab
        losses = []
        t0 = time.time()
        for batch in loader:
            out = step(batch)
            losses.append(out["loss"])
            self._record(out, vocab)
        self._sync()
        if split in self.timing_history:
            self.timing_history[split].append(time.time() - t0)
        return float(torch.stack(losses).float().mean().item()) if losses else 0.0

    def train_epoch(self, epoch: int) -> float:
        return self._epoch("train", self.train_step)

    def eval_epoch(self, split: str) -> float:
        return self._epoch(split, self.eval_step)

    def _metrics(self, loss: float, epoch: Optional[int] = None,
                 skip_tensorboard: bool = False) -> Dict[str, Any]:
        """The recorder's flattened results with the loss, post-processed."""
        metrics = flatten_leaves(self.recorder.calculate_all_groups(
            epoch=epoch, loss=loss, skip_tensorboard=skip_tensorboard))
        metrics["loss"] = loss
        if self.metrics_postprocess is not None:
            metrics = self.metrics_postprocess(metrics)
        return metrics

    # -- mid-run resume -----------------------------------------------------------

    def _save_resume_point(self, epoch: int, best_metrics: Optional[Dict[str, Any]]) -> None:
        """Rolling last.pth + the loop's host-side state, every epoch."""
        lr = self.lr
        self.ckpt.save_rolling(self.state, epoch, meta=_jsonable({
            "early": {"best": self.early.best, "counter": self.early.counter,
                      "should_stop": self.early.should_stop},
            "lr": ({"epoch": lr.epoch, "best": lr._best, "num_bad": lr._num_bad,
                    "cooldown": lr._cooldown, "scale": lr._scale} if lr is not None else None),
            "best_metrics": best_metrics,
            "metrics_history": self.metrics_history,
            "timing_history": self.timing_history,
        }))

    def _try_resume(self):
        """Restore loop and train state from the rolling resume point.
        Returns (next_epoch, best_metrics), or None without one. The
        loaders' epoch counters are fast-forwarded, so the shuffle and the
        pattern draws of epoch N match the uninterrupted run's; the RNG
        states (dropout) restore from the checkpoint."""
        meta = self.ckpt.load_resume_meta()
        if meta is None:
            return None
        self.ckpt.load_checkpoint(self.state, "last")
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
            train_metrics = self._metrics(train_loss, epoch)
            self.metrics_history["train"].append(dict(train_metrics))

            self.recorder.reset()
            val_loss = self.eval_epoch("validation")
            val_metrics = self._metrics(val_loss, epoch)
            self.metrics_history["validation"].append(dict(val_metrics))

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
            metrics = self._metrics(loss, skip_tensorboard=True)
            results[split] = metrics
            if self.metrics_path is None:
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
        if self.metrics_path is None:
            return
        self.metrics_path.mkdir(parents=True, exist_ok=True)
        (self.metrics_path / "epoch_metrics.json").write_text(
            json.dumps(_jsonable(self.epoch_metrics), indent=4))
