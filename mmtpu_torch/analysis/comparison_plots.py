"""Pretrained-vs-baseline comparison figures.

TPU-repo consolidation of the reference's five hardcoded one-off plot
scripts into one parameterized API (each function cites its origin):

- plot_model_comparison          <- plot_comparison.py:25-52
- plot_additional_metrics       <- additional_plots.py:14-107 (2x2 grid)
- plot_cumulative_time          <- plot_time_comparison.py:14-62
- plot_loss_and_epoch_times     <- result_comparison.py:61-90
- plot_phase_time_bars          <- result_comparison.py:91-130
- plot_total_training_time      <- plot_total_training_time.py (stacked
                                   pretrain phases vs baseline bar)

All functions take already-loaded metric lists (mmtpu_torch.analysis.
processing loaders) and an output directory; filenames match the reference
outputs so downstream tooling finds them. Own copy of
`mmtpu/analysis/comparison_plots.py`; matplotlib is imported when a
figure is drawn (`plotting.pyplot`).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from mmtpu_torch.analysis.plotting import pyplot

_PRETRAINED_STYLE = dict(color="tab:blue", marker="o", linewidth=2, markersize=6)
_BASELINE_STYLE = dict(color="tab:red", marker="o", linewidth=2, markersize=6)


def _epochs(ms: Sequence[Dict]) -> range:
    return range(1, len(ms) + 1)


def plot_model_comparison(
    pretrained: List[Dict], baseline: List[Dict], out_dir: Path,
    acc_key: str = "accuracy_AI",
) -> Path:
    """1x2 accuracy/loss curves (reference plot_comparison.py:25-52)."""
    plt = pyplot()
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(15, 6))
    for ax, key, title in ((ax1, acc_key, "Accuracy Comparison"),
                           (ax2, "loss", "Loss Comparison")):
        ax.plot(_epochs(pretrained), [d[key] for d in pretrained],
                label="With Pretraining", **_PRETRAINED_STYLE)
        ax.plot(_epochs(baseline), [d[key] for d in baseline],
                label="Without Pretraining", **_BASELINE_STYLE)
        ax.set_title(title)
        ax.set_xlabel("Epoch")
        ax.set_ylabel(key if key == "loss" else "Accuracy")
        ax.grid(True, linestyle="--", alpha=0.7)
        ax.legend()
    fig.tight_layout()
    path = Path(out_dir) / "model_comparison.png"
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_additional_metrics(
    pretrained: List[Dict], baseline: List[Dict], out_dir: Path,
    acc_key: str = "accuracy_AI", pattern: str = "AI",
) -> Path:
    """2x2 grid: loss+accuracy twin axes, F1 / precision / recall in
    macro/micro/weighted flavours (reference additional_plots.py:14-107)."""
    plt = pyplot()
    fig, axes = plt.subplots(2, 2, figsize=(20, 16))
    (ax1, ax2), (ax3, ax4) = axes

    ax1.plot(_epochs(pretrained), [d["loss"] for d in pretrained],
             label="Loss (With Pretraining)", **_PRETRAINED_STYLE)
    ax1.plot(_epochs(baseline), [d["loss"] for d in baseline],
             label="Loss (Without Pretraining)", **_BASELINE_STYLE)
    ax1_2 = ax1.twinx()
    ax1_2.plot(_epochs(pretrained), [d.get(acc_key, np.nan) for d in pretrained],
               "s-", color="lightblue", label="Accuracy (With Pretraining)")
    ax1_2.plot(_epochs(baseline), [d.get(acc_key, np.nan) for d in baseline],
               "s-", color="lightcoral", label="Accuracy (Without Pretraining)")
    ax1.set_title("Loss and Accuracy over Epochs")
    ax1.set_xlabel("Epoch")
    ax1.set_ylabel("Loss")
    ax1_2.set_ylabel("Accuracy")
    lines1, labels1 = ax1.get_legend_handles_labels()
    lines2, labels2 = ax1_2.get_legend_handles_labels()
    ax1.legend(lines1 + lines2, labels1 + labels2, loc="center right")
    ax1.grid(True, linestyle="--", alpha=0.7)

    for ax, metric, title in ((ax2, "f1", "F1 Scores Comparison"),
                              (ax3, "precision", "Precision Comparison"),
                              (ax4, "recall", "Recall Comparison")):
        for flavour, shade_p, shade_b, mark in (
            ("macro", "tab:blue", "tab:red", "o"),
            ("micro", "lightblue", "lightcoral", "s"),
            ("weighted", "darkblue", "darkred", "^"),
        ):
            key = f"{metric}_{flavour}_{pattern}"
            # a flavour present in either run (or only after epoch 1) must
            # still be plotted; per-epoch gaps fall back to .get(..., nan)
            if not any(key in d for d in [*pretrained, *baseline]):
                continue
            ax.plot(_epochs(pretrained), [d.get(key, np.nan) for d in pretrained],
                    marker=mark, color=shade_p,
                    label=f"{flavour.title()} (With Pretraining)")
            ax.plot(_epochs(baseline), [d.get(key, np.nan) for d in baseline],
                    marker=mark, color=shade_b,
                    label=f"{flavour.title()} (Without Pretraining)")
        ax.set_title(title)
        ax.set_xlabel("Epoch")
        ax.set_ylabel(metric.title())
        ax.grid(True, linestyle="--", alpha=0.7)
        ax.legend(fontsize=9)
    fig.tight_layout()
    path = Path(out_dir) / "model_comparison_metrics.png"
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return path


def _epoch_times(epoch_metrics: List[Dict], split: str = "train") -> List[float]:
    return [
        float(e[split]["timing"]["total_time"])
        for e in epoch_metrics
        if split in e and "timing" in e.get(split, {})
    ]


def plot_cumulative_time(
    pretrained_epochs: List[Dict], baseline_epochs: List[Dict], out_dir: Path,
) -> Path:
    """Cumulative train+val wall per epoch with per-epoch annotations
    (reference plot_time_comparison.py:14-62)."""
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(12, 6))
    for ms, label, style in (
        (pretrained_epochs, "With Pretraining", _PRETRAINED_STYLE),
        (baseline_epochs, "Without Pretraining", _BASELINE_STYLE),
    ):
        times = [
            a + b for a, b in zip(_epoch_times(ms, "train"),
                                  _epoch_times(ms, "validation"))
        ]
        cum = np.cumsum(times)
        ax.plot(range(1, len(cum) + 1), cum, label=label, **style)
        for i in range(0, len(cum), 2):
            ax.annotate(f"{times[i]:.1f}s", (i + 1, cum[i]),
                        textcoords="offset points", xytext=(0, 10),
                        ha="center", fontsize=8, color=style["color"])
    ax.set_title("Cumulative Training Time Comparison")
    ax.set_xlabel("Epoch")
    ax.set_ylabel("Total Time (seconds)")
    ax.grid(True, linestyle="--", alpha=0.7)
    ax.legend()
    fig.tight_layout()
    path = Path(out_dir) / "total_time_comparison_cumulative.png"
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_loss_and_epoch_times(
    runs: Dict[str, List[Dict]], out_dir: Path,
) -> List[Path]:
    """comparison_loss.png + comparison_epoch_times.png over any number of
    labeled runs (reference result_comparison.py:61-90)."""
    plt = pyplot()
    paths = []
    for value, fname, ylabel, title in (
        (lambda e: e["train"]["loss"], "comparison_loss.png", "Loss",
         "Comparison of Loss"),
        (lambda e: e["train"]["timing"]["total_time"],
         "comparison_epoch_times.png", "Time (seconds)",
         "Comparison of Epoch Execution Time"),
    ):
        fig, ax = plt.subplots(figsize=(12, 6))
        for label, ms in runs.items():
            epochs = [e for e in ms if "train" in e]
            ax.plot(range(1, len(epochs) + 1), [value(e) for e in epochs],
                    label=label, linewidth=2)
        ax.set_title(title)
        ax.set_xlabel("Epoch")
        ax.set_ylabel(ylabel)
        ax.grid(True)
        ax.legend()
        path = Path(out_dir) / fname
        fig.savefig(path, dpi=150, bbox_inches="tight")
        plt.close(fig)
        paths.append(path)
    return paths


def plot_phase_time_bars(runs: Dict[str, List[Dict]], out_dir: Path) -> Path:
    """Grouped Train/Validation/Test total-time bars with value labels
    (reference result_comparison.py:91-130)."""
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(14, 8))
    phases = ["Train", "Validation", "Test"]
    x = np.arange(len(phases))
    width = 0.8 / max(len(runs), 1)
    for i, (label, ms) in enumerate(runs.items()):
        train_t = sum(_epoch_times(ms, "train"))
        val_t = sum(_epoch_times(ms, "validation"))
        test_t = sum(
            float(e["test"]["timing"]["total_time"])
            for e in ms
            if "test" in e and "timing" in e.get("test", {})
        )
        offset = (i - (len(runs) - 1) / 2) * width
        bars = ax.bar(x + offset, [train_t, val_t, test_t], width, label=label)
        for bar in bars:
            h = bar.get_height()
            ax.text(bar.get_x() + bar.get_width() / 2, h, f"{h:.1f}",
                    ha="center", va="bottom", fontsize=10)
    ax.set_title("Total Time Comparison by Phase")
    ax.set_xlabel("Phase")
    ax.set_ylabel("Total Time (seconds)")
    ax.set_xticks(x)
    ax.set_xticklabels(phases)
    ax.legend()
    fig.tight_layout()
    path = Path(out_dir) / "comparison_total_time_by_phase.png"
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_total_training_time(
    baseline_time: float,
    pretrain_phase_times: Dict[str, float],
    main_time: float,
    out_dir: Path,
) -> Path:
    """Stacked pretrain-phase bar vs baseline bar, with per-segment and
    total labels (reference plot_total_training_time.py). Returns the png
    path and prints the reference's detailed statistics block."""
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(10, 8))
    bar_width = 0.35
    ax.bar(0, baseline_time, bar_width, label="Baseline (multimodal only)",
           color="tab:red")
    bottom = 0.0
    for name, t in {**pretrain_phase_times, "multimodal": main_time}.items():
        ax.bar(bar_width * 2, t, bar_width, bottom=bottom, label=name)
        ax.text(bar_width * 2, bottom + t / 2, f"{t:.1f}s", ha="center",
                va="center", fontsize=10)
        bottom += t
    ax.text(0, baseline_time / 2, f"{baseline_time:.1f}s", ha="center",
            va="center")
    total = sum(pretrain_phase_times.values()) + main_time
    ax.text(0, baseline_time * 1.05,
            f"Total: {baseline_time:.1f}s\n({baseline_time / 60:.1f}m)",
            ha="center", va="bottom")
    ax.text(bar_width * 2, total * 1.05,
            f"Total: {total:.1f}s\n({total / 60:.1f}m)",
            ha="center", va="bottom")
    ax.set_xticks([0, bar_width * 2])
    ax.set_xticklabels(["Baseline Model", "Pretrained Model"])
    ax.set_ylabel("Time (seconds)")
    ax.set_title("Total Training Time Comparison")
    ax.legend(bbox_to_anchor=(1.05, 1), loc="upper left")
    fig.tight_layout()
    path = Path(out_dir) / "total_time_comparison.png"
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)

    print("\nDetailed time statistics:")
    print(f"Baseline total: {baseline_time:.2f}s ({baseline_time / 60:.2f}m)")
    for name, t in pretrain_phase_times.items():
        print(f"{name} pretraining: {t:.2f}s ({t / 60:.2f}m)")
    print(f"Multimodal training: {main_time:.2f}s ({main_time / 60:.2f}m)")
    print(f"Pretrained total: {total:.2f}s ({total / 60:.2f}m)")
    print(f"Time difference: {abs(total - baseline_time):.2f}s")
    return path


def load_train_metrics(path: str | Path) -> List[Dict]:
    """train_metrics.json loader (flat per-epoch dicts)."""
    return json.loads(Path(path).read_text())
