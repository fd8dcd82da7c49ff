"""Post-hoc plots (own copy of `mmtpu/analysis/plotting.py`; reference:
results_processing/plotting.py:625-1046, avmnist_comparison.py:17-290):
training curves, pretrained-vs-scratch comparisons, confusion matrices,
embedding projections.

Host code. matplotlib (Agg), sklearn, scipy's stats, OpenCV and PIL are
imported inside the functions that draw with them, so the module imports
where they are absent (the card's machine has no sklearn). The UMAP
projection is the port's `umap_embed`, on the card unless `device` says
"cpu"; the t-SNE projection needs sklearn, as in mmtpu, and raises
ImportError without it.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np


def pyplot():
    """matplotlib's pyplot on the Agg backend (files, no display)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_metric_curves(
    histories: Dict[str, List[Dict[str, Any]]],
    metric: str,
    split: str = "validation",
    out: str | Path = "metric_curves.png",
) -> str:
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(6, 4))
    for label, history in histories.items():
        ys = []
        for e in history:
            v = e[split].get("metrics", {}).get(metric)
            if v is None:
                for pat, m in e[split].items():
                    if isinstance(m, dict) and metric in m:
                        v = m[metric]
                        break
            ys.append(v)
        ax.plot(range(1, len(ys) + 1), ys, marker="o", ms=3, label=label)
    ax.set_xlabel("epoch")
    ax.set_ylabel(metric)
    ax.legend()
    ax.grid(alpha=0.3)
    fig.savefig(out, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return str(out)


def plot_loss_curves(
    histories: Dict[str, List[Dict[str, Any]]],
    out: str | Path = "loss_curves.png",
) -> str:
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(6, 4))
    for label, history in histories.items():
        ax.plot(
            [e["train"]["loss"] for e in history], label=f"{label} train", ls="-"
        )
        ax.plot(
            [e["validation"]["loss"] for e in history],
            label=f"{label} val", ls="--",
        )
    ax.set_xlabel("epoch")
    ax.set_ylabel("loss")
    ax.legend()
    ax.grid(alpha=0.3)
    fig.savefig(out, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return str(out)


def plot_confusion_matrix(
    cm: np.ndarray,
    labels: Optional[Sequence[str]] = None,
    out: str | Path = "confusion.png",
    normalize: bool = True,
) -> str:
    plt = pyplot()
    cm = np.asarray(cm, float)
    if normalize:
        cm = cm / np.maximum(cm.sum(axis=1, keepdims=True), 1)
    fig, ax = plt.subplots(figsize=(5, 4.5))
    im = ax.imshow(cm, cmap="Blues")
    fig.colorbar(im)
    n = cm.shape[0]
    ticks = labels if labels is not None else [str(i) for i in range(n)]
    ax.set_xticks(range(n), ticks, rotation=45)
    ax.set_yticks(range(n), ticks)
    for i in range(n):
        for j in range(n):
            ax.text(
                j, i, f"{cm[i, j]:.2f}", ha="center", va="center",
                color="white" if cm[i, j] > cm.max() / 2 else "black", fontsize=7,
            )
    ax.set_xlabel("predicted")
    ax.set_ylabel("true")
    fig.savefig(out, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return str(out)


def plot_pattern_comparison(
    metrics_by_experiment: Dict[str, Dict[str, float]],
    metric_prefix: str,
    out: str | Path = "pattern_comparison.png",
) -> str:
    """Grouped bars of `{prefix}_{PATTERN}` values per experiment
    (the per-pattern robustness view, reference plotting.py:625+)."""
    plt = pyplot()
    patterns = sorted(
        {
            k.rsplit("_", 1)[1]
            for m in metrics_by_experiment.values()
            for k in m
            # '_' guard: a bare key equal to the prefix (e.g. 'loss')
            # passes startswith but has no pattern suffix to split off
            if k.startswith(metric_prefix) and "_" in k
            and k.rsplit("_", 1)[1].isupper()
        }
    )
    fig, ax = plt.subplots(figsize=(6, 4))
    n = max(len(metrics_by_experiment), 1)
    width = 0.8 / n
    for i, (label, metrics) in enumerate(metrics_by_experiment.items()):
        vals = [metrics.get(f"{metric_prefix}_{p}", np.nan) for p in patterns]
        ax.bar(np.arange(len(patterns)) + i * width, vals, width, label=label)
    # center the group label under the group: offset (n-1)/2 bar widths
    ax.set_xticks(np.arange(len(patterns)) + width * (n - 1) / 2, patterns)
    ax.set_ylabel(metric_prefix)
    ax.legend()
    ax.grid(alpha=0.3, axis="y")
    fig.savefig(out, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return str(out)


def plot_embeddings_projection(
    embeddings: np.ndarray,
    labels: Optional[np.ndarray] = None,
    method: str = "pca",
    out: str | Path = "embeddings.png",
    device=None,
) -> str:
    """PCA / t-SNE / UMAP projection (reference plotting.py:665, :781,
    :933 — _compute_pca/_compute_tsne/_compute_umap); UMAP on `device`
    (`umap_lite.umap_embed`'s: the card by default)."""
    plt = pyplot()
    if method == "tsne":
        from sklearn.manifold import TSNE

        pts = TSNE(
            n_components=2, init="pca",
            perplexity=min(30, len(embeddings) - 1),
        ).fit_transform(embeddings)
    elif method == "umap":
        from mmtpu_torch.analysis.umap_lite import umap_embed

        pts = umap_embed(embeddings, n_components=2, device=device)
    else:
        centered = embeddings - embeddings.mean(0)
        _, _, vt = np.linalg.svd(centered, full_matrices=False)
        pts = centered @ vt[:2].T
    fig, ax = plt.subplots(figsize=(5, 4))
    ax.scatter(pts[:, 0], pts[:, 1], c=labels, s=5, cmap="tab10")
    ax.set_title(f"{method.upper()} projection")
    fig.savefig(out, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return str(out)


def get_significance_stars(p_value: float) -> str:
    """Reference processing_utils.py:272-onward star scheme."""
    if p_value < 0.001:
        return "***"
    if p_value < 0.01:
        return "**"
    if p_value < 0.05:
        return "*"
    return "ns"


def plot_modality_available_results_with_significance(
    runs_by_experiment: Dict[str, Dict[str, List[float]]],
    metric_name: str = "",
    out: str | Path = "pattern_significance.png",
) -> str:
    """Per-pattern grouped bars (mean ± std over runs) with pairwise
    significance stars between the two experiments, mirroring reference
    plotting.py:249-370.

    runs_by_experiment: {experiment: {PATTERN: [per-run values]}} — exactly
    two experiments for the pairwise annotation; more are drawn without
    stars.
    """
    plt = pyplot()
    from scipy import stats as sstats

    patterns = sorted(
        {p for runs in runs_by_experiment.values() for p in runs},
        key=lambda x: (len(x), x),
    )
    names = list(runs_by_experiment)
    fig, ax = plt.subplots(figsize=(1.4 * len(patterns) + 2, 4.5))
    width = 0.8 / max(len(names), 1)
    tops = np.zeros(len(patterns))
    for i, name in enumerate(names):
        vals = [runs_by_experiment[name].get(p, []) for p in patterns]
        means = [np.mean(v) if len(v) else np.nan for v in vals]
        stds = [np.std(v) if len(v) > 1 else 0.0 for v in vals]
        xs = np.arange(len(patterns)) + i * width
        ax.bar(xs, means, width, yerr=stds, capsize=3, label=name)
        tops = np.maximum(tops, np.nan_to_num(np.asarray(means) + stds))
    if len(names) == 2:
        for j, p in enumerate(patterns):
            a = runs_by_experiment[names[0]].get(p, [])
            b = runs_by_experiment[names[1]].get(p, [])
            if len(a) >= 2 and len(b) >= 2:
                _, pv = sstats.ttest_ind(a, b, equal_var=False)
                star = get_significance_stars(float(pv))
            elif a and b:
                star = "ns"
            else:
                continue
            x = j + width / 2
            y = tops[j] * 1.02 + 1e-3
            ax.plot([j, j + width], [y, y], lw=1, color="black")
            ax.text(x, y, star, ha="center", va="bottom", fontsize=9)
    ax.set_xticks(np.arange(len(patterns)) + width * (len(names) - 1) / 2,
                  patterns)
    ax.set_ylabel(metric_name or "metric")
    ax.set_xlabel("available modalities")
    ax.legend()
    ax.grid(alpha=0.3, axis="y")
    fig.savefig(out, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return str(out)


def create_video_from_pngs(
    image_paths: Sequence[str | Path],
    output_path: str | Path,
    fps: int = 24,
    linger_time_seconds: float = 3.0,
    size: Optional[tuple] = None,
    codec: str = "mp4v",
) -> None:
    """Stitch epoch plots into a video, lingering on each frame (reference
    plotting.py:565-623). Falls back to an animated GIF via PIL when OpenCV
    is unavailable."""
    paths = [Path(p) for p in image_paths]
    if not paths:
        raise ValueError("The list of image paths is empty.")
    for p in paths:
        if not p.is_file():
            raise FileNotFoundError(f"Image file not found: {p}")
    frames_per_image = max(1, int(fps * linger_time_seconds))
    try:
        import cv2

        first = cv2.imread(str(paths[0]))
        if first is None:
            raise ValueError(f"Failed to read image: {paths[0]}")
        h, w = first.shape[:2]
        if size is not None:
            w, h = size
        video = cv2.VideoWriter(
            str(output_path), cv2.VideoWriter_fourcc(*codec), fps, (w, h)
        )
        try:
            for p in paths:
                img = cv2.imread(str(p))
                if img is None:
                    continue
                img = cv2.resize(img, (w, h))
                for _ in range(frames_per_image):
                    video.write(img)
        finally:
            video.release()
    except ImportError:
        from PIL import Image

        frames = [Image.open(p).convert("RGB") for p in paths]
        if size is not None:
            frames = [f.resize(size) for f in frames]
        frames[0].save(
            str(Path(output_path).with_suffix(".gif")),
            save_all=True, append_images=frames[1:],
            duration=int(linger_time_seconds * 1000), loop=0,
        )
