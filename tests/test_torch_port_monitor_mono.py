"""The monitored monomodal pretraining, `train_monomodal` on a copy of
configs/avmnist/synthetic_mono_audio.yaml with a `monitor_path` (a LeNet
audio encoder in its ResNet18's place, one step), through mmtpu's CLI and
the port's from
mmtpu's initial weights: the port's `monitor_data.h5` is mmtpu's
(`tests/test_torch_port_monitor.py::check_monitored_file`). Apart from that
file's runs so that the two run on separate workers."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_port_monitor import check_monitored_file, monitored_runs  # noqa: E402
from _torch_threads import few_threads  # noqa: E402,F401 — in-process comparisons only


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    yield from monitored_runs(tmp_path_factory, ("monomodal",))


def test_monitored_monomodal_run_writes_mmtpus_file(runs):
    check_monitored_file(runs, "monomodal")
