"""Experiment reports of the port (counterpart of `mmtpu/reports`)."""

from mmtpu_torch.reports.report import (
    ExperimentReportGenerator,
    MetricsReport,
    ModelReport,
    TimingReport,
)

__all__ = ["ExperimentReportGenerator", "MetricsReport", "ModelReport", "TimingReport"]
