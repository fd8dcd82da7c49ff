"""Experiment reports (counterpart of `MetricsReport`, `TimingReport`,
`ModelReport` and the parts of `ExperimentReportGenerator` that use them,
mmtpu/reports/report.py), with no pandas:

- MetricsReport → `{split}_metrics.json` in the reference's records schema
  (pandas `to_json(orient='records')` of one dataframe over all splits:
  'index' runs on across splits, every record carries every split's
  columns, null where a split lacks one, 'split', and 'Epoch' for train and
  validation), and the ConfusionMatrix columns collected per split
  (`confusion_matrices_{split}.npy`);
- TimingReport → `timing.csv`; ModelReport → `model_info.json`.

The LaTeX report, the plots and the embedding projections are not ported.
"""

from __future__ import annotations

import csv
import json
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
from torch import nn


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


class MetricsReport:
    def __init__(self, output_dir: Path) -> None:
        self.output_dir = Path(output_dir)
        self.confusion_matrices: Dict[str, Dict[str, list]] = {}

    def generate(self, metrics_history: Dict[str, List[Dict[str, Any]]],
                 test_metrics: Optional[Dict[str, Dict[str, Any]]] = None) -> Dict[str, str]:
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self.confusion_matrices = {}

        def drop_cm(split, m):
            out = {}
            for k, v in m.items():
                if "ConfusionMatrix" in k:
                    self.confusion_matrices.setdefault(split, {}).setdefault(k, []).append(
                        np.asarray(v))
                else:
                    out[k] = v
            return out

        splits = [(split, [drop_cm(split, m) for m in history])
                  for split, history in metrics_history.items()]
        for split, metrics in (test_metrics or {}).items():
            splits.append((split, [drop_cm(split, metrics)]))
        union: List[str] = []
        for _, records in splits:
            for m in records:
                union.extend(k for k in m if k not in union)

        written, offset = {}, 0
        for split, records in splits:
            payload = []
            for i, m in enumerate(records):
                row = {"index": offset + i, **{k: m.get(k) for k in union}, "split": split}
                if split in ("train", "validation"):
                    row["Epoch"] = i + 1
                payload.append(row)
            offset += len(records)
            path = self.output_dir / f"{split}_metrics.json"
            path.write_text(json.dumps(_jsonable(payload), indent=4))
            written[split] = str(path)
        return written


class TimingReport:
    def __init__(self, output_dir: Path) -> None:
        self.output_dir = Path(output_dir)

    def generate(self, timing_history: Dict[str, List[float]]) -> str:
        self.output_dir.mkdir(parents=True, exist_ok=True)
        path = self.output_dir / "timing.csv"
        splits = [s for s in timing_history if timing_history[s]]
        n = max((len(timing_history[s]) for s in splits), default=0)
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["epoch"] + [f"{s}_time_s" for s in splits])
            for i in range(n):
                w.writerow([i + 1] + [round(timing_history[s][i], 4)
                                      if i < len(timing_history[s]) else "" for s in splits])
        return str(path)


class ModelReport:
    def __init__(self, output_dir: Path) -> None:
        self.output_dir = Path(output_dir)

    def generate(self, model: nn.Module) -> Dict[str, Any]:
        params = list(model.parameters())
        info = {"total_parameters": int(sum(p.numel() for p in params)),
                "size_mb": round(sum(p.numel() * p.element_size() for p in params) / 2**20, 3)}
        self.output_dir.mkdir(parents=True, exist_ok=True)
        (self.output_dir / "model_info.json").write_text(json.dumps(info, indent=4))
        return info


class ExperimentReportGenerator:
    """`{split}_metrics.json` and the confusion matrices into `metrics_dir`
    (default: the report dir), timing and model info into the report dir."""

    def __init__(self, output_dir, experiment_name: str, metrics_dir=None) -> None:
        self.output_dir = Path(output_dir)
        self.metrics_dir = Path(metrics_dir) if metrics_dir else self.output_dir
        self.experiment_name = experiment_name

    def generate_report(self, *, metrics_history: Dict[str, List[Dict[str, Any]]],
                        timing_history: Dict[str, List[float]], model: nn.Module,
                        test_metrics: Optional[Dict[str, Dict[str, Any]]] = None
                        ) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        metrics_report = MetricsReport(self.metrics_dir)
        out["metrics"] = metrics_report.generate(metrics_history, test_metrics)
        for split, cms in metrics_report.confusion_matrices.items():
            # a dict in a 0-d object array, as mmtpu writes it
            np.save(self.metrics_dir / f"confusion_matrices_{split}.npy", cms,  # type: ignore[arg-type]
                    allow_pickle=True)
        out["timing"] = TimingReport(self.output_dir).generate(timing_history)
        out["model"] = ModelReport(self.output_dir).generate(model)
        return out
