"""Offline analysis of `monitor_data.h5` (counterpart of
`mmtpu/monitor/analysis.py`), numpy over the file: the reference analyser's
API (per-epoch, per-layer statistics of gradients, activations and weights,
their evolution over the epochs, a summary) with the measures it derives
(iqr, range, dead_fraction, sparsity, frobenius_norm, the spectral
measures), and the per-layer trajectories. It reads a file written by
either package; h5py is imported when a file is opened.
"""

from __future__ import annotations

from collections import defaultdict
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import numpy as np

from mmtpu_torch.monitor.storage import import_h5py


def _derive(stats: Dict[str, float], kind: str) -> Dict[str, float]:
    """Measures the reference derives from raw tensors
    (stats.py:12-55) reconstructed from the stored columns."""
    out = dict(stats)
    if "p75" in out and "p25" in out:
        out["iqr"] = out["p75"] - out["p25"]
    if "max" in out and "min" in out:
        out["range"] = out["max"] - out["min"]
    if kind == "gradients":
        out["l1_norm"] = out.pop("l1", out.get("l1_norm", 0.0))
        out["l2_norm"] = out.pop("l2", out.get("l2_norm", 0.0))
    if kind == "activations" and "positive_fraction" in out:
        out["dead_fraction"] = 1.0 - out["positive_fraction"]
        out["sparsity"] = out.get("zero_fraction", 0.0)
    if kind == "weights" and "l2" in out:
        out["frobenius_norm"] = out["l2"]
    return out


class MonitoringAnalyser:
    def __init__(self, path: Union[str, Path]) -> None:
        h5py = import_h5py()
        self.path = Path(path)
        self._file = h5py.File(self.path, "r")

    def close(self) -> None:
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- raw walking ----------------------------------------------------------

    def _walk(self, group: str):
        h5py = import_h5py()

        def visit(prefix, node, out):
            for key, item in node.items():
                name = f"{prefix}/{key}" if prefix else key
                if isinstance(item, h5py.Dataset):
                    cols = item.attrs.get("columns", "")
                    out.append((name, np.asarray(item), str(cols)))
                else:
                    visit(name, item, out)

        out: List = []
        if group in self._file:
            visit("", self._file[group], out)
        return out

    @staticmethod
    def _split(name: str):
        parts = name.split("/")
        epoch = step = None
        layer_parts = []
        for p in parts:
            if p.startswith("epoch_"):
                epoch = int(p.split("_")[1])
            elif p.startswith("step_"):
                step = int(p.split("_")[1])
            else:
                layer_parts.append(p)
        return epoch, step, "/".join(layer_parts)

    # -- reference analyser API -----------------------------------------------

    def _analyze(self, group: str, layers: Optional[List[str]] = None,
                 start_epoch: Optional[int] = None,
                 end_epoch: Optional[int] = None) -> Dict[int, Dict[str, Any]]:
        """epoch → layer → stats dict (latest capture of the epoch),
        mirroring analyze_gradients/activations/weights
        (analyser.py:12-110)."""
        per: Dict[int, Dict[str, Any]] = defaultdict(dict)
        spectral: Dict[int, Dict[str, Dict[str, float]]] = defaultdict(dict)
        for name, data, cols in self._walk(group):
            epoch, step, layer = self._split(name)
            if epoch is None:
                continue
            if start_epoch is not None and epoch < start_epoch:
                continue
            if end_epoch is not None and epoch > end_epoch:
                continue
            if layer.endswith("__spectral"):
                base = layer[: -len("__spectral")]
                spectral[epoch][base] = dict(
                    zip(cols.split(","), data.tolist())
                )
                continue
            if layers and not any(p in layer for p in layers):
                continue
            names = cols.split(",") if cols else [
                f"c{i}" for i in range(len(data))
            ]
            stats = _derive(dict(zip(names, data.tolist())), group)
            prev = per[epoch].get(layer)
            if prev is None or (step is not None and
                                prev.get("_step", -1) <= step):
                stats["_step"] = step if step is not None else 0
                per[epoch][layer] = stats
        for epoch, by_layer in spectral.items():
            for base, extra in by_layer.items():
                if base in per.get(epoch, {}):
                    per[epoch][base].update(extra)
        for by_layer in per.values():
            for stats in by_layer.values():
                stats.pop("_step", None)
        return dict(per)

    def analyze_gradients(self, layers=None, start_epoch=None, end_epoch=None):
        return self._analyze("gradients", layers, start_epoch, end_epoch)

    def analyze_activations(self, layers=None, start_epoch=None, end_epoch=None):
        return self._analyze("activations", layers, start_epoch, end_epoch)

    def analyze_weights(self, layers=None, start_epoch=None, end_epoch=None):
        return self._analyze("weights", layers, start_epoch, end_epoch)

    def get_temporal_evolution(
        self, metric: str, layer: Optional[str] = None
    ) -> Dict[str, List[Dict[str, Any]]]:
        """layer → [{'epoch': N, 'stats': {...}}, ...] (analyser.py:112-146)."""
        valid = {"gradients", "activations", "weights"}
        if metric not in valid:
            raise ValueError(f"Metric must be one of {valid}")
        per = self._analyze(metric)
        evolution: Dict[str, List[Dict[str, Any]]] = defaultdict(list)
        for epoch in sorted(per):
            for lname, stats in per[epoch].items():
                if layer and layer not in lname:
                    continue
                evolution[lname].append({"epoch": epoch, "stats": stats})
        return dict(evolution)

    def get_summary_statistics(self) -> Dict[str, Any]:
        """All-metric summary (analyser.py:148-165)."""
        grads = self.analyze_gradients()
        return {
            "gradients": grads,
            "activations": self.analyze_activations(),
            "weights": self.analyze_weights(),
            "training_duration": {"epochs": len(grads)},
        }

    # -- trajectory view ------------------------------------------------------------

    def gradient_stats(self) -> Dict[str, Dict[str, List[float]]]:
        """layer → {stat: [...]} ordered by (epoch, step)."""
        return self._collect("gradients")

    def activation_stats(self) -> Dict[str, Dict[str, List[float]]]:
        return self._collect("activations")

    def weight_stats(self) -> Dict[str, Dict[str, List[float]]]:
        return self._collect("weights")

    def _collect(self, group: str) -> Dict[str, Dict[str, List[float]]]:
        by_layer: Dict[str, List] = defaultdict(list)
        col_names: Dict[str, List[str]] = {}
        for name, data, cols in self._walk(group):
            epoch, step, layer = self._split(name)
            if layer.endswith("__spectral"):
                continue
            by_layer[layer].append(((epoch or 0, step or 0), data))
            col_names[layer] = cols.split(",") if cols else []
        out: Dict[str, Dict[str, List[float]]] = {}
        for layer, rows in by_layer.items():
            rows.sort(key=lambda r: r[0])
            mat = np.stack([r[1] for r in rows])
            names = col_names[layer] or [f"c{i}" for i in range(mat.shape[1])]
            out[layer] = {col: mat[:, i].tolist() for i, col in enumerate(names)}
        return out

    def summary(self) -> Dict[str, Any]:
        g = self.gradient_stats()
        return {
            "num_layers_tracked": len(g),
            "vanishing_gradients": [
                layer for layer, s in g.items()
                if s.get("l2") and max(s["l2"]) < 1e-7
            ],
            "exploding_gradients": [
                layer for layer, s in g.items()
                if s.get("l2") and max(s["l2"]) > 1e3
            ],
        }
