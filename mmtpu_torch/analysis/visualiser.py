"""Experiment visualiser (own copy of `mmtpu/analysis/visualiser.py`;
reference: experiment_utils/experiment_visualiser.py:24-499).

Publication-style views over a runs dataframe with a 'Modality Availability'
column and metric columns (one row per run × condition):
distribution violins, paired-difference boxes vs the full-modality
condition, multi-metric comparisons, pairwise significance / effect-size
heatmaps, forest plots, and validation-over-epochs curves. matplotlib
(`plotting.pyplot`), seaborn and scipy's stats are imported when a view
is drawn.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from mmtpu_torch.analysis.plotting import pyplot

FONT_SIZE_LABELS = 11
FONT_SIZE_TITLE = 13


class ExperimentVisualiser:
    def __init__(self, output_dir: str | Path) -> None:
        self.output_dir = Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)

    def _save(self, fig, name: str) -> Path:
        plt = pyplot()
        out = self.output_dir / f"{name}.png"
        fig.savefig(out, dpi=150, bbox_inches="tight")
        plt.close(fig)
        return out

    @staticmethod
    def _format_metric_name(metric: str) -> str:
        return metric.replace("_", " ").title()

    # -- distribution -----------------------------------------------------

    def plot_performance_distribution(
        self, df, metric: str, title: Optional[str] = None,
        figsize: Tuple[float, float] = (10, 6),
    ) -> Path:
        """Violin + box + jittered points per modality condition
        (reference :89-133)."""
        plt = pyplot()
        import seaborn as sns

        fig, ax = plt.subplots(figsize=figsize)
        sns.violinplot(data=df, x="Modality Availability", y=metric, ax=ax,
                       inner=None, alpha=0.3)
        sns.boxplot(data=df, x="Modality Availability", y=metric, ax=ax,
                    width=0.2, color="white", showfliers=False)
        sns.stripplot(data=df, x="Modality Availability", y=metric, ax=ax,
                      size=4, alpha=0.5, jitter=0.2)
        ax.set_xlabel("Modality Availability", fontsize=FONT_SIZE_LABELS)
        ax.set_ylabel(self._format_metric_name(metric),
                      fontsize=FONT_SIZE_LABELS)
        if title:
            ax.set_title(title, fontsize=FONT_SIZE_TITLE, pad=20)
        plt.xticks(rotation=45, ha="right")
        return self._save(fig, f"performance_distribution_{metric}")

    # -- paired differences -------------------------------------------------

    def plot_paired_differences(
        self, df, metric: str, reference_condition: str = "Full",
        figsize: Tuple[float, float] = (10, 6),
    ) -> Path:
        """Per-condition differences vs the reference condition
        (reference :135-195)."""
        plt = pyplot()
        import seaborn as sns

        if metric == "loss":  # not a paired-difference metric; a blank
            return None        # figure would be saved otherwise
        fig, ax = plt.subplots(figsize=figsize)
        ref = df[df["Modality Availability"] == reference_condition][
            metric
        ].values
        diffs, labels = [], []
        for cond in df["Modality Availability"].unique():
            if cond == reference_condition:
                continue
            vals = df[df["Modality Availability"] == cond][metric].values
            n = min(len(vals), len(ref))
            diffs.append(vals[:n] - ref[:n])
            # label matches the computed sign: cond MINUS reference
            labels.append(f"{cond} − {reference_condition}")
        sns.boxplot(data=diffs, orient="h", ax=ax, showfliers=False)
        for i, d in enumerate(diffs):
            ax.scatter(d, np.full(len(d), i) + np.random.default_rng(i)
                       .uniform(-0.15, 0.15, len(d)), s=12, alpha=0.5)
        ax.axvline(0, color="gray", ls="--", alpha=0.5)
        ax.set_yticks(range(len(labels)), labels, fontsize=FONT_SIZE_LABELS)
        ax.set_xlabel(f"Difference in {self._format_metric_name(metric)}",
                      fontsize=FONT_SIZE_LABELS)
        ax.set_title(
            f"Performance Impact Relative to {reference_condition}",
            fontsize=FONT_SIZE_TITLE, pad=20,
        )
        return self._save(fig, f"paired_differences_{metric}")

    # -- multi-metric comparison ---------------------------------------------

    def plot_metric_comparison(
        self, df, metrics: List[str],
        figsize: Tuple[float, float] = (12, 6),
    ) -> Path:
        """Grouped mean±std bars per condition over several metrics
        (reference :197-277)."""
        plt = pyplot()
        conds = list(df["Modality Availability"].unique())
        fig, ax = plt.subplots(figsize=figsize)
        width = 0.8 / max(len(metrics), 1)
        for i, metric in enumerate(metrics):
            means = [df[df["Modality Availability"] == c][metric].mean()
                     for c in conds]
            stds = [df[df["Modality Availability"] == c][metric].std()
                    for c in conds]
            ax.bar(np.arange(len(conds)) + i * width, means, width,
                   yerr=stds, capsize=3,
                   label=self._format_metric_name(metric))
        ax.set_xticks(
            np.arange(len(conds)) + width * (len(metrics) - 1) / 2, conds,
            rotation=45, ha="right",
        )
        ax.set_ylabel("Value", fontsize=FONT_SIZE_LABELS)
        ax.legend()
        ax.grid(alpha=0.3, axis="y")
        return self._save(fig, "metric_comparison")

    # -- significance matrix ---------------------------------------------------

    def plot_significance_matrix(
        self, df, metric: str, figsize: Tuple[float, float] = (12, 5),
    ) -> Path:
        """Pairwise Welch-t p-values and Cohen's d heatmaps
        (reference :297-369)."""
        plt = pyplot()
        import seaborn as sns
        from scipy import stats as sstats

        conds = list(df["Modality Availability"].unique())
        n = len(conds)
        pvals = np.ones((n, n))
        effects = np.zeros((n, n))
        for i, a in enumerate(conds):
            for j, b in enumerate(conds):
                if i == j:
                    continue
                va = df[df["Modality Availability"] == a][metric].values
                vb = df[df["Modality Availability"] == b][metric].values
                if len(va) > 1 and len(vb) > 1:
                    _, p = sstats.ttest_ind(va, vb, equal_var=False)
                    pooled = np.sqrt((np.var(va, ddof=1) + np.var(vb, ddof=1)) / 2)
                    d = (va.mean() - vb.mean()) / pooled if pooled else 0.0
                    pvals[i, j] = p
                    effects[i, j] = d
        fig, (ax1, ax2) = plt.subplots(1, 2, figsize=figsize)
        sns.heatmap(pvals, annot=True, fmt=".3f", xticklabels=conds,
                    yticklabels=conds, cmap="RdYlGn_r", vmax=0.1, ax=ax1)
        ax1.set_title("Pairwise p-values", fontsize=FONT_SIZE_TITLE)
        sns.heatmap(effects, annot=True, fmt=".2f", xticklabels=conds,
                    yticklabels=conds, cmap="coolwarm", center=0, ax=ax2)
        ax2.set_title("Pairwise effect sizes (Cohen's d)",
                      fontsize=FONT_SIZE_TITLE)
        return self._save(fig, f"significance_matrix_{metric}")

    # -- forest plot -------------------------------------------------------------

    def plot_forest_significance(
        self, df, metric: str, reference_condition: str = "Full",
        figsize: Tuple[float, float] = (8, 6),
    ) -> Path:
        """Cohen's d vs the reference condition with 95% CIs
        (reference :371-413)."""
        plt = pyplot()
        from scipy import stats as sstats

        ref = df[df["Modality Availability"] == reference_condition][
            metric
        ].values
        rows = []
        for cond in df["Modality Availability"].unique():
            if cond == reference_condition:
                continue
            vals = df[df["Modality Availability"] == cond][metric].values
            if len(vals) < 2 or len(ref) < 2:
                continue
            pooled = np.sqrt((np.var(vals, ddof=1) + np.var(ref, ddof=1)) / 2)
            d = (vals.mean() - ref.mean()) / pooled if pooled else 0.0
            se = np.sqrt(
                (len(vals) + len(ref)) / (len(vals) * len(ref))
                + d**2 / (2 * (len(vals) + len(ref)))
            )
            _, p = sstats.ttest_ind(vals, ref, equal_var=False)
            rows.append((cond, d, se, p))
        fig, ax = plt.subplots(figsize=figsize)
        ys = np.arange(len(rows))
        for y, (cond, d, se, p) in zip(ys, rows):
            ax.errorbar(d, y, xerr=1.96 * se, fmt="o", color="black",
                        capsize=4)
            ax.text(d, y + 0.18, f"p={p:.3f}", ha="center", fontsize=8)
        ax.axvline(0, color="gray", ls="--", alpha=0.5)
        ax.set_yticks(ys, [r[0] for r in rows])
        ax.set_xlabel(f"Cohen's d vs {reference_condition}",
                      fontsize=FONT_SIZE_LABELS)
        ax.set_title(f"Effect sizes: {self._format_metric_name(metric)}",
                     fontsize=FONT_SIZE_TITLE)
        return self._save(fig, f"forest_significance_{metric}")

    # -- epochs ------------------------------------------------------------------

    def plot_validation_over_epochs(
        self, metric_by_condition: Dict[str, List[float]], metric: str,
        figsize: Tuple[float, float] = (8, 5),
    ) -> Path:
        """Per-condition validation trajectories (reference :415-438)."""
        plt = pyplot()
        fig, ax = plt.subplots(figsize=figsize)
        for cond, values in metric_by_condition.items():
            ax.plot(range(1, len(values) + 1), values, marker="o", ms=3,
                    label=cond)
        ax.set_xlabel("Epoch", fontsize=FONT_SIZE_LABELS)
        ax.set_ylabel(self._format_metric_name(metric),
                      fontsize=FONT_SIZE_LABELS)
        ax.legend()
        ax.grid(alpha=0.3)
        return self._save(fig, f"validation_over_epochs_{metric}")

    # -- batch --------------------------------------------------------------------

    def create_all_visualizations(
        self, df, metrics: List[str], reference_condition: str = "Full",
    ) -> Dict[str, Path]:
        """Run every view for every metric (reference :440-499)."""
        out: Dict[str, Path] = {}
        for metric in metrics:
            out[f"distribution_{metric}"] = self.plot_performance_distribution(
                df, metric
            )
            paired = self.plot_paired_differences(
                df, metric, reference_condition
            )
            if paired is not None:  # loss has no paired-difference view
                out[f"paired_{metric}"] = paired
            out[f"significance_{metric}"] = self.plot_significance_matrix(
                df, metric
            )
            out[f"forest_{metric}"] = self.plot_forest_significance(
                df, metric, reference_condition
            )
        out["comparison"] = self.plot_metric_comparison(df, metrics)
        return out
