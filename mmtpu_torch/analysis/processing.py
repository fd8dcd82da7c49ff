"""Post-hoc metric processing (own copy of `mmtpu/analysis/processing.py`;
reference: results_processing/processing_utils.py:19-709,
experiment_utils/experiment_analyser.py:42).

Loaders for the epoch_metrics.json / test_metrics.json artifacts (mmtpu's
and the port's write the same), multi-run aggregation (mean/std), pairwise
significance tests, and LaTeX tables. Host code: pandas and scipy are
imported inside the functions that use them."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np


def load_epoch_metrics(path: str | Path) -> List[Dict[str, Any]]:
    return json.loads(Path(path).read_text())


def load_test_metrics(path: str | Path) -> Dict[str, Any]:
    return json.loads(Path(path).read_text())


def _runs(experiment_dir: str | Path, filename: str) -> List[Path]:
    root = Path(experiment_dir) / "metrics"
    return sorted(root.glob(f"*/{filename}"))


def _lookup_metric(entry_split: Dict[str, Any], metric: str):
    """Metric value from an epoch entry's split body — the generic
    nesting ('metrics' bucket) OR the avmnist style (pattern keys)."""
    v = entry_split.get("metrics", {}).get(metric)
    if v is None:
        for metrics in entry_split.values():
            if isinstance(metrics, dict) and metric in metrics:
                return metrics[metric]
    return v


def aggregate_runs(
    experiment_dir: str | Path,
    metric: str,
    split: str = "validation",
    mode: str = "max",
) -> Dict[str, Any]:
    """Mean/std of a metric's best value across run_id subdirectories.

    mode='min' for lower-is-better metrics (loss, MAE) — taking max there
    would aggregate each run's WORST epoch. Handles both the generic
    nesting and the avmnist pattern-nested epoch_metrics.json."""
    best = max if mode == "max" else min
    values = []
    for path in _runs(experiment_dir, "epoch_metrics.json"):
        history = load_epoch_metrics(path)
        per_epoch = [
            _lookup_metric(e[split], metric)
            for e in history
            if split in e
        ]
        per_epoch = [v for v in per_epoch if v is not None]
        if per_epoch:
            values.append(best(per_epoch))
    if not values:
        return {"metric": metric, "runs": 0}
    return {
        "metric": metric,
        "runs": len(values),
        "mean": float(np.mean(values)),
        "std": float(np.std(values)),
        "values": values,
    }


def significance_test(a: Sequence[float], b: Sequence[float]) -> Dict[str, float]:
    """Welch t-test + Mann-Whitney U (reference ExperimentAnalyser)."""
    from scipy import stats

    a, b = np.asarray(a, float), np.asarray(b, float)
    out: Dict[str, float] = {}
    if len(a) > 1 and len(b) > 1:
        t, p = stats.ttest_ind(a, b, equal_var=False)
        out["t_statistic"], out["t_pvalue"] = float(t), float(p)
        u, p_u = stats.mannwhitneyu(a, b, alternative="two-sided")
        out["u_statistic"], out["u_pvalue"] = float(u), float(p_u)
    out["mean_diff"] = float(np.mean(a) - np.mean(b))
    return out


def compare_experiments(
    dir_a: str | Path,
    dir_b: str | Path,
    metric: str,
    split: str = "validation",
    mode: str = "max",
) -> Dict[str, Any]:
    agg_a = aggregate_runs(dir_a, metric, split, mode=mode)
    agg_b = aggregate_runs(dir_b, metric, split, mode=mode)
    out = {"a": agg_a, "b": agg_b}
    if agg_a.get("values") and agg_b.get("values"):
        out["significance"] = significance_test(agg_a["values"], agg_b["values"])
    return out


def epochs_to_threshold(
    history: List[Dict[str, Any]],
    metric: str,
    threshold: float,
    split: str = "train",
) -> Optional[int]:
    """First epoch reaching a threshold (the 'epochs to 99% accuracy'
    convergence statistic in BASELINE.md)."""
    for e in history:
        v = e[split].get("metrics", {}).get(metric)
        if v is None:
            # avmnist nesting: look under pattern keys
            for pat, metrics in e[split].items():
                if isinstance(metrics, dict) and metric in metrics:
                    v = metrics[metric]
                    break
        if v is not None and v >= threshold:
            return e["epoch"]
    return None


def phase_time_comparison(
    pretrain_dirs: Sequence[str | Path],
    main_history_path: str | Path,
    scratch_history_path: str | Path,
) -> Dict[str, float]:
    """Pretrain+main vs scratch wall-time comparison
    (reference avmnist_comparison.plot_phase_time_comparison :237)."""

    def total_time(path: str | Path) -> float:
        hist = load_epoch_metrics(path)
        return sum(
            e[s]["timing"]["total_time"]
            for e in hist
            for s in ("train", "validation")
            if s in e and "timing" in e[s]
        )

    pretrain = sum(total_time(p) for p in pretrain_dirs)
    main = total_time(main_history_path)
    scratch = total_time(scratch_history_path)
    return {
        "pretrain_time_s": round(pretrain, 2),
        "main_time_s": round(main, 2),
        "scratch_time_s": round(scratch, 2),
        "total_vs_scratch_pct": round(100 * (pretrain + main - scratch) / scratch, 2)
        if scratch
        else float("nan"),
        "main_vs_scratch_pct": round(100 * (main - scratch) / scratch, 2)
        if scratch
        else float("nan"),
    }


def latex_table(
    rows: Dict[str, Dict[str, float]], caption: str = "", precision: int = 4
) -> str:
    """rows: {row_name: {col: value}} → booktabs LaTeX table."""
    cols = sorted({c for r in rows.values() for c in r})
    header = " & ".join(["Experiment"] + [c.replace("_", r"\_") for c in cols])
    lines = [
        r"\begin{table}[ht]\centering",
        rf"\caption{{{caption}}}" if caption else "",
        r"\begin{tabular}{l" + "r" * len(cols) + "}",
        r"\toprule",
        header + r" \\",
        r"\midrule",
    ]
    for name, vals in rows.items():
        cells = [
            f"{vals[c]:.{precision}f}" if isinstance(vals.get(c), float) else str(vals.get(c, ""))
            for c in cols
        ]
        lines.append(" & ".join([name.replace("_", r"\_")] + cells) + r" \\")
    lines += [r"\bottomrule", r"\end{tabular}", r"\end{table}"]
    return "\n".join(l for l in lines if l)


# ---------------------------------------------------------------------------
# run-corpus loaders + statistics (reference processing_utils.py:19-709)
# ---------------------------------------------------------------------------

def get_run_data(root: str | Path, debug: bool = False) -> List[Path]:
    """All numeric run directories under <root>/metrics
    (processing_utils.py:19-42)."""
    import re

    root = Path(root)
    runs = sorted(
        p for p in (root / "metrics").glob("*")
        if p.is_dir() and re.match(r"^\d+", p.name)
    )
    if debug:
        print(f"Found {len(runs)} runs in {root}.")
    return runs


def extract_modality_availability(s: str) -> str:
    """'f1_weighted_AI' → 'AI' (processing_utils.py:44-56)."""
    return s.rsplit("_", 1)[-1]


def extract_metric(s: str) -> str:
    """'f1_weighted_AI' → 'f1_weighted' (processing_utils.py:58-70)."""
    return s.rsplit("_", 1)[0]


def load_test_metrics_df(fp: str | Path, extract_key=None):
    """One run's test_metrics.json → single-row DataFrame with
    ConfusionMatrix / index / split columns dropped
    (processing_utils.py:72-108)."""
    import json as _json

    import pandas as pd

    with open(fp) as f:
        metrics = _json.load(f)
    metrics = metrics[0] if isinstance(metrics, list) else metrics
    if extract_key:
        metrics = metrics[extract_key]
    metrics = {k: v for k, v in metrics.items() if "ConfusionMatrix" not in k}
    df = pd.DataFrame([metrics])
    return df.drop(
        columns=[c for c in ("index", "split") if c in df.columns]
    ).reset_index(drop=True)


def load_all_test_metrics(
    files: Sequence[str | Path],
    test_metrics_name: str = "test_metrics.json",
    drop_loss: bool = True,
    extract_key=None,
):
    """Concat per-run test metrics into a runs × metrics DataFrame
    (processing_utils.py:202-248)."""
    import pandas as pd

    dfs = [
        load_test_metrics_df(Path(fp) / test_metrics_name,
                             extract_key=extract_key)
        for fp in files
    ]
    df = pd.concat(dfs, ignore_index=True)
    if drop_loss and "loss" in df.columns:
        df = df.drop(columns=["loss"])
    return df


def to_metric_modality_index(df, remove_prefix=None):
    """runs × metrics → MultiIndex (Metric, Modalities Available) × runs."""
    import pandas as pd

    t = df.T
    modalities = t.index.map(extract_modality_availability)
    metrics = t.index.map(extract_metric)
    if remove_prefix:
        metrics = metrics.str.replace(remove_prefix, "")
    t.index = pd.MultiIndex.from_tuples(
        list(zip(metrics, modalities)), names=["Metric", "Modalities Available"]
    )
    return t


def fdr_bh(p_values) -> np.ndarray:
    """Benjamini–Hochberg corrected p-values (the reference uses
    statsmodels.multipletests(method='fdr_bh'); that package isn't in this
    image, so the standard step-up procedure is implemented directly)."""
    p = np.asarray(p_values, float)
    n = len(p)
    order = np.argsort(p)
    ranked = p[order] * n / (np.arange(n) + 1)
    # enforce monotonicity from the largest down
    ranked = np.minimum.accumulate(ranked[::-1])[::-1]
    out = np.empty(n)
    out[order] = np.clip(ranked, 0, 1)
    return out


def calculate_within_modality_stats(
    run_data,
    metrics_to_test: Dict[str, float],
    baseline_modality: str = "ATV",
):
    """Per-(metric, modality) one-sample t vs chance and two-sample t vs the
    full-modality baseline, with Cohen's d and BH-FDR correction
    (processing_utils.py:110-199)."""
    import pandas as pd
    from scipy import stats as sstats

    chance_rows, baseline_rows = [], []
    metrics = run_data.index.get_level_values("Metric").unique()
    modalities = run_data.index.get_level_values("Modalities Available").unique()
    baseline = {
        m: run_data.loc[(m, baseline_modality)].values
        for m in metrics if (m, baseline_modality) in run_data.index
    }
    for metric in metrics:
        chance = next(
            (lvl for pat, lvl in metrics_to_test.items() if pat in metric),
            None,
        )
        for modality in modalities:
            if (metric, modality) not in run_data.index:
                continue
            runs = run_data.loc[(metric, modality)].values
            if chance is not None:
                t, p = sstats.ttest_1samp(runs, chance)
                d = (np.mean(runs - chance) / np.std(runs)
                     if np.std(runs) != 0 else 0.0)
                chance_rows.append({
                    "Metric": metric, "Modalities Available": modality,
                    "t_statistic": float(t), "p_value": float(p),
                    "cohens_d": float(d), "compared_to": "chance",
                })
            if modality != baseline_modality and metric in baseline:
                base = baseline[metric]
                t, p = sstats.ttest_ind(runs, base)
                n1, n2 = len(runs), len(base)
                var1 = np.var(runs, ddof=1)
                var2 = np.var(base, ddof=1)
                pooled = np.sqrt(
                    ((n1 - 1) * var1 + (n2 - 1) * var2) / max(n1 + n2 - 2, 1)
                )
                d = ((np.mean(runs) - np.mean(base)) / pooled
                     if pooled != 0 else 0.0)
                baseline_rows.append({
                    "Metric": metric, "Modalities Available": modality,
                    "t_statistic": float(t), "p_value": float(p),
                    "cohens_d": float(d), "compared_to": baseline_modality,
                })
    chance_df = pd.DataFrame(chance_rows)
    baseline_df = pd.DataFrame(baseline_rows)
    for df in (chance_df, baseline_df):
        if not df.empty:
            df["p_value_corrected"] = fdr_bh(df["p_value"])
    return chance_df, baseline_df


def calculate_stats(df) -> Dict[str, Any]:
    """Basic stats + 95% t-CIs across run columns
    (processing_utils.py:399-436)."""
    import pandas as pd
    from scipy import stats as sstats

    cols = df.columns
    basic = pd.DataFrame({
        "mean": df[cols].mean(axis=1),
        "std": df[cols].std(axis=1),
        "min": df[cols].min(axis=1),
        "max": df[cols].max(axis=1),
        "median": df[cols].median(axis=1),
        "q25": df[cols].quantile(0.25, axis=1),
        "q75": df[cols].quantile(0.75, axis=1),
        "sem": df[cols].apply(lambda x: sstats.sem(x), axis=1),
        "n_runs": df[cols].notna().sum(axis=1),
    }).round(4)
    ci = df[cols].apply(
        lambda x: sstats.t.interval(
            confidence=0.95, df=len(x) - 1, loc=np.mean(x),
            scale=sstats.sem(x),
        ),
        axis=1,
    )
    ci_df = pd.DataFrame({
        "ci_lower": [c[0] for c in ci],
        "ci_upper": [c[1] for c in ci],
    }).round(4)
    return {"basic_stats": basic, "confidence_intervals": ci_df}


def pivot_data_to_modalities_available(
    df, index: str = "Metric",
    values=("Value", "p_value", "significance", "cohens_d", "t_statistic"),
):
    """Pivot so modalities become column groups (processing_utils.py:439-456)."""
    values = [v for v in values if v in df.columns]
    return (
        df.pivot(index=index, columns=["Modalities Available"], values=values)
        .swaplevel(axis=1)
        .sort_index(axis=1)
    )


def write_latex_to_file(df, file_name: str | Path) -> None:
    """Two-half landscape LaTeX tables (processing_utils.py:458-506)."""
    df = df.copy()
    for col in df.columns:
        try:
            df[col] = df[col].map(lambda x: f"{float(x):.3f}")
        except (ValueError, TypeError):
            pass
    n = len(df.columns)
    halves = [df.iloc[:, : n // 2], df.iloc[:, n // 2:]] if n > 1 else [df]

    def make_table(d) -> str:
        return d.to_latex(
            escape=True, longtable=False, multicolumn=True,
            multicolumn_format="c",
            column_format="|l|" + "c|" * len(d.columns),
        )

    template = (
        "\\afterpage{\n\\clearpage\n\\begin{landscape}\n\\begin{table}\n"
        "\\setlength\\tabcolsep{4pt}\n\\fontsize{12}{14}\\selectfont\n"
        "\\resizebox{1.5\\textwidth}{!}{\n%s}\n\\end{table}\n"
        "\\end{landscape}\n\\clearpage}\n"
    )
    Path(file_name).write_text(
        "".join(template % make_table(h) for h in halves if len(h.columns))
    )


def load_validation_metrics_df(run_dir: str | Path):
    """validation_metrics.json records → DataFrame
    (processing_utils.py:508-524)."""
    import pandas as pd

    df = pd.read_json(Path(run_dir) / "validation_metrics.json")
    return df.drop(
        columns=[c for c in ("index", "split") if c in df.columns]
    ).reset_index(drop=True)


def load_all_validation_metrics(
    files: Sequence[str | Path],
    round: int | None = 4,
    remove_prefix=None,
    drop_loss: bool = True,
    drop_columns=None,
):
    """Per-epoch means across runs, MultiIndexed by (Modalities, Metric)
    (processing_utils.py:526-573)."""
    import pandas as pd

    dfs = [load_validation_metrics_df(fp) for fp in files]
    combined = pd.concat(dfs, ignore_index=True)
    if drop_loss and "loss" in combined.columns:
        combined = combined.drop(columns=["loss"])
    if drop_columns:
        combined = combined.drop(columns=drop_columns)
    combined = combined.groupby("Epoch").mean()
    if round is not None:
        combined = combined.round(round)
    t = to_metric_modality_index(combined, remove_prefix)
    return pd.DataFrame(t).T.swaplevel(axis=1).sort_index(axis=1)


def split_validation_metrics_by_available_modalities(idf, modalities):
    """{metric: DataFrame(epochs × modalities)}
    (processing_utils.py:576-594)."""
    import pandas as pd

    metrics = sorted({m for _, m in idf.columns})
    out = {}
    for metric in metrics:
        data = {
            mod: idf[(mod, metric)] for mod in modalities
            if (mod, metric) in idf.columns
        }
        df = pd.DataFrame(data)
        df.index.name = "Index"
        out[metric] = df
    return out


def load_confusion_matrices(root: str | Path, split: str = "test"):
    """confusion_matrices_{split}.npy dict (processing_utils.py:597-603)."""
    return np.load(
        Path(root) / f"confusion_matrices_{split}.npy", allow_pickle=True
    ).item()


def load_all_confusion_matrices(files, split: str = "test"):
    from collections import defaultdict

    out: Dict[int, Dict[str, list]] = defaultdict(lambda: defaultdict(list))
    for i, fp in enumerate(files, 1):
        for k, v in load_confusion_matrices(fp, split).items():
            out[i][k].extend(v)
    return out


def compute_mean_confusion_matrix_per_epoch(run_confusion_matrices):
    """Mean CM per epoch across runs (processing_utils.py:618-646)."""
    if not run_confusion_matrices:
        raise ValueError("The input dictionary is empty.")
    run_data = list(run_confusion_matrices.values())
    return [
        np.mean(epoch_cms, axis=0).astype(int)
        for epoch_cms in zip(*run_data)
    ]


def load_embeddings(
    root: str | Path, modality, include_reconstructions: bool = False,
    embeddings_dir: str = "embeddings",
) -> np.ndarray:
    """{modality}_embeddings.npy (+ optional stacked reconstructions)
    (processing_utils.py:649-683)."""
    root = Path(root)
    emb = np.load(root / embeddings_dir / f"{modality}_embeddings.npy")
    if include_reconstructions:
        rec = np.load(root / embeddings_dir / f"{modality}_reconstructions.npy")
        if emb.shape != rec.shape:
            raise ValueError(
                "Embeddings and reconstructed embeddings must have the same shape."
            )
        emb = np.stack([emb, rec], axis=2)
    return emb


def load_all_embeddings(files, modalities, include_reconstructions=False):
    """Faithful quirk (reference processing_utils.py:704-708): keyed by
    modality only, so with multiple roots each overwrites the previous —
    the result holds the LAST root's embeddings. Reproduced for API
    parity; pass a single root (or call load_embeddings per root) for
    multi-run analysis."""
    out = {}
    for root in files:
        for modality in modalities:
            out[modality] = load_embeddings(
                root, modality, include_reconstructions
            )
    return out
