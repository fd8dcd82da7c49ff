"""Buffered HDF5 sink of the monitor (counterpart of `mmtpu/monitor/storage.py`).

`monitor_data.h5` holds the groups `gradients`, `activations`, `weights`
and `convergence`. Records are buffered and written `buffer_size` at a
time, and on `flush`; a record gets gzip (or the configured compression)
only when it has more than one element, and a name written again replaces
the earlier dataset. Mode "w" starts a fresh file, "a" appends to a
previous run's (`--resume`). h5py is imported here only, when the file is
opened: a machine without it cannot write the file.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

GROUPS = ("gradients", "activations", "weights", "convergence")


def import_h5py():
    """h5py, or an ImportError that says the monitor needs it."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            "monitoring.enabled needs h5py to write <monitor_path>/monitor_data.h5, and "
            "it is not installed: install h5py, or pass --disable_monitoring") from e
    return h5py


class MonitorStorage:
    def __init__(self, path: Union[str, Path], buffer_size: int = 1000,
                 compression: Optional[str] = "gzip", compression_opts: int = 4,
                 mode: str = "w") -> None:
        h5py = import_h5py()
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.buffer_size = buffer_size
        self.compression = compression
        self.compression_opts = compression_opts
        self._buffer: List[Tuple[str, str, Dict[str, Any], np.ndarray]] = []
        self._file = h5py.File(self.path, mode)
        for g in GROUPS:
            if g not in self._file:
                self._file.create_group(g)

    def append(self, group: str, name: str, data: np.ndarray,
               attrs: Optional[Dict[str, Any]] = None) -> None:
        if group not in GROUPS:
            raise ValueError(f"Unknown monitor group: {group}")
        self._buffer.append((group, name, attrs or {}, np.asarray(data)))
        if len(self._buffer) >= self.buffer_size:
            self.flush()

    def flush(self) -> None:
        for group, name, attrs, data in self._buffer:
            grp = self._file[group]
            if name in grp:
                del grp[name]
            kwargs = {}
            if self.compression and data.ndim > 0 and data.size > 1:
                kwargs = dict(compression=self.compression,
                              compression_opts=self.compression_opts)
            ds = grp.create_dataset(name, data=data, **kwargs)
            for k, v in attrs.items():
                ds.attrs[k] = v
        self._buffer.clear()
        self._file.flush()

    def close(self) -> None:
        if self._file.id.valid:
            self.flush()
            self._file.close()


class MemoryStorage:
    """The sink's interface over a dict, `records[group][name] = (data,
    attrs)`, as the file would hold them after a flush: for a machine with
    no h5py, where a caller checks what the monitor records."""

    def __init__(self) -> None:
        self.records: Dict[str, Dict[str, Tuple[np.ndarray, Dict[str, Any]]]] = {
            g: {} for g in GROUPS}

    def append(self, group: str, name: str, data: np.ndarray,
               attrs: Optional[Dict[str, Any]] = None) -> None:
        if group not in GROUPS:
            raise ValueError(f"Unknown monitor group: {group}")
        self.records[group][name] = (np.asarray(data), dict(attrs or {}))

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass
