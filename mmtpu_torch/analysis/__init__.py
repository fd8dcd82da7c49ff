"""Post-hoc analysis of runs (counterpart of `mmtpu/analysis/`): run JSON
loaders, aggregates, significance tests and tables (`processing`), plots
(`plotting`, `comparison_plots`, `visualiser`) and the UMAP projection on
the card (`umap_lite`)."""

from mmtpu_torch.analysis.processing import (
    aggregate_runs,
    compare_experiments,
    latex_table,
    load_epoch_metrics,
    load_test_metrics,
    significance_test,
)

__all__ = [
    "aggregate_runs",
    "compare_experiments",
    "latex_table",
    "load_epoch_metrics",
    "load_test_metrics",
    "significance_test",
]
