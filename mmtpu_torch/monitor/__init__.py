"""The HDF5 experiment monitor (counterpart of `mmtpu/monitor`)."""

from mmtpu_torch.monitor.analysis import MonitoringAnalyser
from mmtpu_torch.monitor.monitor import ExperimentMonitor
from mmtpu_torch.monitor.storage import MemoryStorage, MonitorStorage

__all__ = ["ExperimentMonitor", "MemoryStorage", "MonitorStorage", "MonitoringAnalyser"]
