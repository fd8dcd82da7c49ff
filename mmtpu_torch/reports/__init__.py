"""Experiment reports of the port (counterpart of `mmtpu/reports`)."""

from mmtpu_torch.reports.report import (
    EmbeddingVisualizationReport,
    ExperimentReportGenerator,
    LatexReport,
    MetricsReport,
    ModelReport,
    TimingReport,
    split_missing_conditions,
)

__all__ = [
    "EmbeddingVisualizationReport",
    "ExperimentReportGenerator",
    "LatexReport",
    "MetricsReport",
    "ModelReport",
    "TimingReport",
    "split_missing_conditions",
]
