"""Experiment reports (counterpart of `MetricsReport`, `TimingReport`,
`ModelReport` and the parts of `ExperimentReportGenerator` that use them,
mmtpu/reports/report.py), with no pandas:

- MetricsReport → `{split}_metrics.json` in the reference's records schema
  (pandas `to_json(orient='records')` of one dataframe over all splits:
  'index' runs on across splits, every record carries every split's
  columns, null where a split lacks one, 'split', and 'Epoch' for train and
  validation), and the ConfusionMatrix columns collected per split
  (`confusion_matrices_{split}.npy`);
- TimingReport → `timing.csv`; ModelReport → `model_info.json`;
- EmbeddingVisualizationReport → `{mod}_embeddings_pca.png`, a PCA scatter
  of each exported `{mod}_embeddings.npy` coloured by `labels.npy`
  (matplotlib, imported only where a plot is drawn; without it the plot is
  skipped with a warning, the embeddings stay);
- LatexReport → `report.tex` (model size, the last validation epoch's
  metrics, one table per split and missing-modality condition from
  `split_missing_conditions`, mean epoch times), the same text as mmtpu's
  from the same inputs; compiled with `pdflatex` when it is on the PATH.
"""

from __future__ import annotations

import csv
import json
import logging
import shutil
import subprocess
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
from torch import nn

logger = logging.getLogger(__name__)


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


def split_missing_conditions(metrics: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    """Group flat metric keys by their trailing pattern suffix:
    'accuracy_AI' → {'AI': {'accuracy': ...}}; keys without one go under
    'overall'."""
    out: Dict[str, Dict[str, Any]] = {}
    for key, value in metrics.items():
        base, _, suffix = key.rpartition("_")
        if "_" in key and suffix.isupper() and 1 <= len(suffix) <= 4:
            out.setdefault(suffix, {})[base] = value
        else:
            out.setdefault("overall", {})[key] = value
    return out


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


class EmbeddingVisualizationReport:
    def __init__(self, output_dir: Path) -> None:
        self.output_dir = Path(output_dir)

    def generate(self, embeddings_dir: Path) -> Optional[str]:
        embeddings_dir = Path(embeddings_dir)
        if not embeddings_dir.exists():
            return None
        labels_fp = embeddings_dir / "labels.npy"
        labels = np.load(labels_fp) if labels_fp.exists() else None
        paths = []
        for npy in sorted(embeddings_dir.glob("*_embeddings.npy")):
            emb = np.load(npy)
            if emb.ndim != 2 or emb.shape[0] < 3:
                continue
            centered = emb - emb.mean(0)
            _, _, vt = np.linalg.svd(centered, full_matrices=False)
            pts = centered @ vt[:2].T
            try:
                import matplotlib
            except ImportError:
                logger.warning("matplotlib is not installed: no embedding plots")
                return None
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            fig, ax = plt.subplots(figsize=(5, 4))
            c = labels[: len(pts)] if labels is not None else None
            if c is not None and c.ndim > 1:
                c = c.argmax(-1)
            ax.scatter(pts[:, 0], pts[:, 1], c=c, s=4, cmap="tab10")
            ax.set_title(npy.stem.replace("_embeddings", "") + " (PCA)")
            out = self.output_dir / f"{npy.stem}_pca.png"
            self.output_dir.mkdir(parents=True, exist_ok=True)
            fig.savefig(out, dpi=120, bbox_inches="tight")
            plt.close(fig)
            paths.append(str(out))
        return paths[0] if paths else None


_TEX_UNDERSCORE = r"\_"


def _tex_rows(metrics: Dict[str, Any]) -> str:
    """One `name & value \\\\` row per number, sorted by name, with the
    underscores of the name escaped."""
    return "\n".join(f"{k.replace('_', _TEX_UNDERSCORE)} & {v:.4f} \\\\"
                     for k, v in sorted(metrics.items()) if isinstance(v, (int, float)))


class LatexReport:
    TEMPLATE = r"""\documentclass{article}
\usepackage{booktabs,graphicx,geometry}
\geometry{margin=1in}
\title{%(title)s}
\begin{document}
\maketitle
\section{Model}
Total parameters: %(params)s (%(size)s MB)
\section{Final Metrics}
\begin{tabular}{lr}\toprule Metric & Value \\ \midrule
%(metric_rows)s
\bottomrule\end{tabular}
%(condition_sections)s
\section{Timing}
Mean train epoch: %(train_time)s s; mean validation epoch: %(val_time)s s.
\end{document}
"""

    def __init__(self, output_dir: Path, title: str) -> None:
        self.output_dir = Path(output_dir)
        self.title = title

    def generate(self, model_info: Dict[str, Any], final_metrics: Dict[str, Any],
                 timing: Dict[str, List[float]],
                 condition_tables: Optional[Dict[str, Dict[str, Any]]] = None) -> str:
        cond_tex = ""
        for name, metrics in (condition_tables or {}).items():
            body = _tex_rows(metrics)
            if body:  # the condition's name goes in as it is, as in mmtpu
                cond_tex += (f"\n\\subsection{{{name}}}\n"
                             "\\begin{tabular}{lr}\\toprule Metric & Value \\\\ \\midrule\n"
                             f"{body}\n\\bottomrule\\end{{tabular}}\n")
        tex = self.TEMPLATE % {
            "title": self.title.replace("_", r"\_"),
            "params": model_info.get("total_parameters", "?"),
            "size": model_info.get("size_mb", "?"),
            "metric_rows": _tex_rows(final_metrics),
            "condition_sections": cond_tex,
            "train_time": round(float(np.mean(timing.get("train", [0]) or [0])), 2),
            "val_time": round(float(np.mean(timing.get("validation", [0]) or [0])), 2),
        }
        self.output_dir.mkdir(parents=True, exist_ok=True)
        tex_path = self.output_dir / "report.tex"
        tex_path.write_text(tex)
        if shutil.which("pdflatex"):
            try:
                subprocess.run(["pdflatex", "-interaction=nonstopmode", tex_path.name],
                               cwd=self.output_dir, capture_output=True, timeout=120)
            except (OSError, subprocess.SubprocessError) as e:
                logger.warning(f"pdflatex failed: {e}")
        else:
            logger.info("pdflatex not available; wrote report.tex only")
        return str(tex_path)


class ExperimentReportGenerator:
    """`{split}_metrics.json` and the confusion matrices into `metrics_dir`
    (default: the report dir); timing, model info, the embedding plots and
    `report.tex` into the report dir."""

    def __init__(self, output_dir, experiment_name: str, metrics_dir=None) -> None:
        self.output_dir = Path(output_dir)
        self.metrics_dir = Path(metrics_dir) if metrics_dir else self.output_dir
        self.experiment_name = experiment_name

    def generate_report(self, *, metrics_history: Dict[str, List[Dict[str, Any]]],
                        timing_history: Dict[str, List[float]], model: nn.Module,
                        test_metrics: Optional[Dict[str, Dict[str, Any]]] = None,
                        embeddings_dir: Optional[Path] = None) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        metrics_report = MetricsReport(self.metrics_dir)
        out["metrics"] = metrics_report.generate(metrics_history, test_metrics)
        for split, cms in metrics_report.confusion_matrices.items():
            # a dict in a 0-d object array, as mmtpu writes it
            np.save(self.metrics_dir / f"confusion_matrices_{split}.npy", cms,  # type: ignore[arg-type]
                    allow_pickle=True)
        out["timing"] = TimingReport(self.output_dir).generate(timing_history)
        model_info = ModelReport(self.output_dir).generate(model)
        out["model"] = model_info
        if embeddings_dir is not None:
            out["embedding_plot"] = EmbeddingVisualizationReport(
                self.output_dir).generate(embeddings_dir)
        final = {}
        for hist in metrics_history.get("validation", [])[-1:]:
            final = {k: v for k, v in hist.items() if isinstance(v, (int, float))}
        # one table per (split, condition): the last validation epoch and
        # each test split, by trailing pattern suffix
        sources = {"validation": final}
        for split, metrics in (test_metrics or {}).items():
            sources[split] = {k: v for k, v in metrics.items() if isinstance(v, (int, float))}
        condition_tables = {
            f"{split}-{cond}": vals
            for split, metrics in sources.items()
            for cond, vals in split_missing_conditions(metrics).items() if cond != "overall"}
        out["latex"] = LatexReport(self.output_dir, self.experiment_name).generate(
            model_info, final, timing_history, condition_tables)
        return out
