"""MetricRecorder — per-(group, pattern) accumulation, epoch-end compute
(counterpart of `mmtpu/train/recorder.py`).

`update_group_ids` stores the step's device tensors untouched — no copy to
the host in the hot loop. At epoch end `calculate_*` concatenates each
group's tensors on the device and copies them to the host once, drops the
padded rows, splits them by pattern, and feeds each pattern's rows to the
metric functions the config names. Result keys are
``{metric}[_{subkey}]_{PATTERN}``, the pattern upper-cased with 'z'
stripped, as in mmtpu and the reference.

With a `tensorboard_path`, every scalar result of a train or validation
epoch goes to a tfevents file (`utils/tb_writer.py`) as mmtpu writes it:
tag ``{group}_{key}``, step the epoch, keys containing 'loss' left out,
and, with `tb_record_only`, only keys that one of its regexes matches at
the start (`re.match`). The test pass writes nothing there.
"""

from __future__ import annotations

import logging
import re
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from mmtpu_torch.config.metrics import MetricConfig

logger = logging.getLogger(__name__)


def _first_seen(batch_of: np.ndarray, ids: np.ndarray) -> list:
    """The pattern ids in the order mmtpu's recorder first files them (it
    splits batch by batch): by the first batch that holds each, ties by id.
    That order is the order of the result keys and of the JSON files."""
    n = int(ids.max(initial=0)) + 1
    order = []
    for key in np.unique(batch_of.astype(np.int64) * n + ids):
        if key % n not in order:
            order.append(int(key % n))
    return order


class MetricRecorder:
    def __init__(self, config: MetricConfig, tensorboard_path: Optional[str] = None,
                 tb_record_only: Optional[List[str]] = None) -> None:
        self.config = config
        self.metrics: Dict[str, Callable] = {
            name: mdef.load() for name, mdef in config.metrics.items()
        }
        self.metric_kwargs: Dict[str, Dict[str, Any]] = {
            name: mdef.kwargs for name, mdef in config.metrics.items()
        }
        # group → pattern name → list of (preds, targets) host arrays
        self.group_data: Dict[str, Dict[str, List]] = defaultdict(lambda: defaultdict(list))
        # group → list of (preds, targets, pattern_ids, vocab, mask), on the device
        self._deferred: Dict[str, List] = defaultdict(list)
        self.current_results: Dict[str, Dict[str, Any]] = {}
        self.tb_record_only = tb_record_only
        self.writer = None
        if tensorboard_path:
            from mmtpu_torch.utils.tb_writer import SummaryWriter

            self.writer = SummaryWriter(log_dir=str(tensorboard_path))

    def _check_group(self, group_name: str) -> None:
        if group_name not in self.config.groups:
            raise ValueError(f"Unknown metric group: {group_name}")

    def update_group(self, group_name: str, predictions, targets, modality) -> None:
        """One host batch of one pattern (`modality`, its name); the shapes
        must agree (mmtpu raises at update time too)."""
        self._check_group(group_name)
        predictions, targets = np.asarray(predictions), np.asarray(targets)
        if predictions.shape != targets.shape:
            raise ValueError(f"Shape mismatch between predictions {predictions.shape} "
                             f"and targets {targets.shape}")
        self.group_data[group_name][str(modality)].append((predictions, targets))

    def update_group_all(self, group_name: str, predictions, targets, m_types) -> None:
        """A host batch split by its per-sample pattern names."""
        m_types = np.asarray(m_types)
        predictions, targets = np.asarray(predictions), np.asarray(targets)
        for m_type in np.unique(m_types):
            mask = m_types == m_type
            self.update_group(group_name, predictions[mask], targets[mask], m_type)

    def update_group_ids(self, group_name: str, predictions, targets, pattern_ids,
                         vocab: Sequence[str], sample_mask=None) -> None:
        """Store (still asynchronous) device tensors; the pattern split
        happens on the host at epoch end."""
        self._check_group(group_name)
        self._deferred[group_name].append(
            (predictions, targets, pattern_ids, tuple(vocab), sample_mask))

    def _materialize(self) -> None:
        """One device→host copy per group and key, then the pattern split."""
        for group, items in self._deferred.items():
            vocabs = {v for *_, v, _ in items}
            if len(vocabs) != 1:
                raise ValueError(f"group {group!r}: batches of one epoch with "
                                 f"different pattern vocabularies {sorted(vocabs)}")
            vocab = vocabs.pop()

            def host(i):
                return torch.cat([torch.as_tensor(it[i]) for it in items]).cpu().numpy()

            preds, targets, ids = host(0), host(1), host(2)
            batch_of = np.repeat(np.arange(len(items)), [it[0].shape[0] for it in items])
            if all(it[4] is not None for it in items):
                keep = host(4).astype(bool)
                preds, targets, ids = preds[keep], targets[keep], ids[keep]
                batch_of = batch_of[keep]
            for pid in _first_seen(batch_of, ids):
                sel = ids == pid
                self.group_data[group][vocab[int(pid)]].append((preds[sel], targets[sel]))
        self._deferred.clear()

    def calculate_metrics_for_group(self, group_name: str, epoch: Optional[int] = None,
                                    loss: Optional[float] = None,
                                    skip_tensorboard: bool = False) -> Dict[str, Any]:
        self._check_group(group_name)
        self._materialize()
        group_metrics = self.config.get_group_metrics(group_name)
        results: Dict[str, Any] = {"loss": loss} if loss is not None else {}
        for modality, data in self.group_data[group_name].items():
            if not data:
                continue
            all_preds = np.concatenate([p for p, _ in data], axis=0)
            all_targets = np.concatenate([t for _, t in data], axis=0)
            pattern_key = modality.replace("z", "").upper() if modality else ""
            for metric_name in group_metrics:
                fn = self.metrics[metric_name]
                try:
                    value = fn(all_targets, all_preds, **self.metric_kwargs.get(metric_name, {}))
                except (ValueError, TypeError, ZeroDivisionError) as e:
                    # as mmtpu: a metric that cannot be computed on this
                    # slice is reported and left out, the epoch goes on
                    logger.error(f"Metric {metric_name} failed: {e}")
                    continue
                if isinstance(value, dict):
                    for k, v in value.items():
                        results[f"{metric_name}_{k}_{pattern_key}"] = v
                else:
                    if isinstance(value, np.ndarray):
                        value = value.tolist()
                    results[f"{metric_name}_{pattern_key}"] = value
        if self.writer is not None and not skip_tensorboard:
            self._log_tensorboard(results, group_name, epoch)
        self.current_results[group_name] = results
        return results

    def calculate_all_groups(self, epoch: Optional[int] = None, loss: Optional[float] = None,
                             skip_tensorboard: bool = False) -> Dict[str, Dict[str, Any]]:
        return {group: self.calculate_metrics_for_group(group, epoch=epoch, loss=loss,
                                                        skip_tensorboard=skip_tensorboard)
                for group in self.config.groups}

    def reset(self) -> None:
        self.group_data.clear()
        self._deferred.clear()
        self.current_results.clear()

    def _log_tensorboard(self, results: Dict[str, Any], group_name: str,
                         epoch: Optional[int]) -> None:
        for key, value in results.items():
            if isinstance(value, (list, dict)) or "loss" in key:
                continue
            if self.tb_record_only and not any(re.match(p, key) for p in self.tb_record_only):
                continue
            try:
                scalar = float(value)
            except (TypeError, ValueError):  # a non-scalar metric value
                continue
            self.writer.add_scalar(f"{group_name}_{key}", scalar, epoch or 0)

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()
