"""The port's device-resident epoch (`mmtpu_torch/train/device_loop.py` and
`TrainLoop`'s resident path) against mmtpu's scan epoch and the port's own
streaming path, at the widths of mmtpu's `tests/test_device_loop.py`
(AVMNIST over two FcEncoders, 96 train and 32 validation samples, batch
32), on the CPU.

- mmtpu's scan epoch and the port's resident one from mmtpu's initial
  weights: train and validation losses and metrics at 1e-5;
- resident vs streaming in the port, dropout 0.5: equal;
- `--eval-batch-factor` 3 with a partial tail bit-identical to factor 1,
  `_auto_eval_factor`'s cases, the cumulative budget;
- `--resume` on the resident path equal to an uninterrupted run;
- `build_schedule` equal to mmtpu's, bit for bit;
- the test-time restore of the best checkpoint.
"""

import json
import sys
import tempfile
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_device_loop import build_loop as jax_build_loop  # noqa: E402

from mmtpu.data.avmnist import SyntheticAVMNIST as JaxSyntheticAVMNIST  # noqa: E402
from mmtpu.train import device_loop as jax_dl  # noqa: E402
from mmtpu_torch.checkpoints import from_jax_variables  # noqa: E402
from mmtpu_torch.checkpoints.manager import CheckpointManager  # noqa: E402
from mmtpu_torch.config.metrics import MetricConfig, MetricDef  # noqa: E402
from mmtpu_torch.config.optim import OptimizerConfig  # noqa: E402
from mmtpu_torch.data.avmnist import SyntheticAVMNIST  # noqa: E402
from mmtpu_torch.data.loader import BatchLoader  # noqa: E402
from mmtpu_torch.models import seeded_init  # noqa: E402
from mmtpu_torch.models.avmnist import AVMNIST  # noqa: E402
from mmtpu_torch.models.fc import FcEncoder  # noqa: E402
from mmtpu_torch.train import device_loop as dl  # noqa: E402
from mmtpu_torch.train.early_stopping import EarlyStopping  # noqa: E402
from mmtpu_torch.train.loop import TrainLoop, _auto_eval_factor  # noqa: E402
from mmtpu_torch.train.losses import LossFunctionGroup  # noqa: E402
from mmtpu_torch.train.optim import LRController, build_optimizer  # noqa: E402
from mmtpu_torch.train.recorder import MetricRecorder  # noqa: E402
from mmtpu_torch.train.state import TrainState  # noqa: E402
from mmtpu_torch.train.step import ClassificationTask  # noqa: E402
from _torch_threads import few_threads  # noqa: E402,F401 — in-process comparisons only

CPU = torch.device("cpu")
TOL = 1e-5


def port_loop(device_resident, eval_batch_factor=1, ckpt_dir=None, epochs=2,
              metrics_path=None, resume=False, dropout=0.0, lr_kind=None, lr_args=None,
              val_samples=32, params=None, **loop_kw):
    """mmtpu's `build_loop` recipe in the port; `params` are mmtpu's initial
    weights, else a seeded init."""
    ds_tr = SyntheticAVMNIST(split="train", num_samples=96, selected_patterns=["ai"], seed=1)
    ds_va = SyntheticAVMNIST(split="valid", num_samples=val_samples,
                             selected_patterns=["ai", "a", "i"], seed=1)
    loaders = {"train": BatchLoader(ds_tr, 32, shuffle=True, seed=5),
               "validation": BatchLoader(ds_va, 32)}
    model = AVMNIST(FcEncoder(3008, [16], dropout=0.0), FcEncoder(784, [16], dropout=0.0),
                    hidden_dim=16, dropout=dropout)
    if params is None:
        seeded_init(model, 0)
    else:
        model.load_state_dict(from_jax_variables(params, target=model), strict=True)
    torch.manual_seed(0)
    optimizer, _ = build_optimizer(OptimizerConfig(name="Adam", default_kwargs={"lr": 1e-3}),
                                   model)
    task = ClassificationTask(model=model, loss_group=LossFunctionGroup.from_dict(
        {"ce": {"loss_name": "cross_entropy", "weight": 1.0}}), input_keys=("audio", "image"))
    mc = MetricConfig(metrics={"accuracy": MetricDef(function="sklearn.metrics.accuracy_score")},
                      groups={"classification": ["accuracy"]})
    return TrainLoop(
        task=task, state=TrainState(model=model, optimizer=optimizer), loaders=loaders,
        recorder=MetricRecorder(mc),
        checkpoint_manager=CheckpointManager(ckpt_dir or tempfile.mkdtemp()), device=CPU,
        epochs=epochs, early_stopping=EarlyStopping(enabled=False),
        device_resident=device_resident, eval_batch_factor=eval_batch_factor,
        metrics_path=metrics_path, resume=resume,
        lr_controller=LRController(lr_kind, lr_args or {}, 1e-3) if lr_kind else None,
        **loop_kw)


def _strip_timing(entries):
    return [{k: ({kk: vv for kk, vv in v.items() if kk != "timing"} if isinstance(v, dict)
                 else v) for k, v in e.items()} for e in entries]


@pytest.fixture(scope="module")
def scan_pair():
    """mmtpu's scan loop and the port's resident loop from the same initial
    weights, two epochs each."""
    jloop = jax_build_loop("on")
    assert jloop._scan
    params = jax.tree_util.tree_map(np.asarray, jloop.state.params)
    ploop = port_loop("on", params=params)
    assert set(ploop._resident) == {"train", "validation"}
    jloop.run()
    ploop.run()
    return jloop, ploop


@pytest.mark.parametrize("split", ["train", "validation"])
def test_resident_epochs_match_mmtpu_scan(scan_pair, split):
    jloop, ploop = scan_pair
    for a, b in zip(jloop.epoch_metrics, ploop.epoch_metrics):
        np.testing.assert_allclose(b[split]["loss"], a[split]["loss"], rtol=TOL)
        for pattern, vals in a[split].items():
            if isinstance(vals, dict) and pattern != "timing":
                for key, v in vals.items():
                    np.testing.assert_allclose(b[split][pattern][key], v, rtol=TOL, atol=TOL)


def test_resident_parameters_match_mmtpu_scan(scan_pair):
    jloop, ploop = scan_pair
    want = from_jax_variables(jax.tree_util.tree_map(np.asarray, jloop.state.params),
                              target=ploop.state.model)
    got = ploop.state.model.state_dict()
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0, atol=10 * TOL, err_msg=k)
    assert ploop.state.step == int(jloop.state.step) == 6


def test_qualifying_loop_is_resident_by_default_and_custom_steps_stream():
    assert set(port_loop("auto")._resident) == {"train", "validation"}
    assert not port_loop("off")._resident
    assert not port_loop("auto", record_fn=lambda *a: None)._resident
    loop = port_loop("off")
    builders = (lambda task, state, device: loop.train_step,
                lambda task, device, mesh: loop.eval_step)
    assert not port_loop("auto", step_builders=builders)._resident


def test_resident_equals_streaming_with_dropout_on():
    """The resident path gathers on the device and runs the same step, so its
    dropout draws are the streaming path's: equal epochs, dropout 0.5."""
    runs = []
    for mode in ("off", "on"):
        loop = port_loop(mode, dropout=0.5, eval_batch_factor=None)
        loop.run()
        runs.append(loop)
    stream, resident = runs
    assert resident._resident["validation"].sub_batches == 3
    for a, b in zip(stream.epoch_metrics, resident.epoch_metrics):
        for split in ("train", "validation"):
            np.testing.assert_allclose(b[split]["loss"], a[split]["loss"], rtol=1e-6)
    assert _strip_timing(stream.epoch_metrics)[-1]["validation"].keys() == \
        _strip_timing(resident.epoch_metrics)[-1]["validation"].keys()
    for (n, p), q in zip(stream.state.model.named_parameters(),
                         resident.state.model.parameters()):
        torch.testing.assert_close(q, p, rtol=0, atol=1e-6, msg=n)


def test_eval_batch_factor_bit_identical_with_tail():
    """40 × 3 patterns = 120 eval rows at B = 32: four original batches, the
    last 24 rows; factor 3 fuses them into two steps of 96 (the second
    padded) and reduces the loss per original batch."""
    base = port_loop("on", val_samples=40)
    base.run()
    fused = port_loop("on", eval_batch_factor=3, val_samples=40)
    assert fused._resident["validation"].batch_size == 96
    assert fused._resident["train"].batch_size == 32
    fused.run()
    for a, b in zip(base.epoch_metrics, fused.epoch_metrics):
        assert a["validation"]["loss"] == b["validation"]["loss"]
        assert _strip_timing([a])[0]["validation"] == _strip_timing([b])[0]["validation"]


def test_eval_batch_factor_auto():
    assert _auto_eval_factor(128, 30000) == 8
    assert _auto_eval_factor(512, 30000) == 2
    assert _auto_eval_factor(1024, 30000) == 1
    assert _auto_eval_factor(32, 96) == 3
    loop = port_loop("on", eval_batch_factor=None)
    assert loop._resident["validation"].batch_size == 96
    assert loop._resident["train"].batch_size == 32


def test_auto_budget_is_cumulative(monkeypatch):
    """Splits that each fit but together do not: train is admitted, the
    validation split streams."""
    monkeypatch.setattr(dl, "dataset_nbytes", lambda ds: 60)
    monkeypatch.setattr(dl, "DEFAULT_BUDGET_BYTES", 100)
    loop = port_loop("auto")
    assert "train" in loop._resident and "validation" not in loop._resident
    assert set(port_loop("on")._resident) == {"train", "validation"}


def test_dataset_nbytes_counts_the_needed_arrays():
    ds = SyntheticAVMNIST(split="train", num_samples=96, selected_patterns=["ai"], seed=1)
    jds = JaxSyntheticAVMNIST(split="train", num_samples=96, selected_patterns=["ai"], seed=1)
    assert dl.dataset_nbytes(ds) == jax_dl.dataset_nbytes(jds) > 0


@pytest.mark.parametrize("case", [
    # (split, batch, epoch, shuffle, drop_last, base batch)
    ("train", 32, 0, True, False, None),
    ("train", 32, 3, True, False, None),
    ("train", 20, 1, False, True, None),
    ("valid", 96, 0, False, False, 32),
    ("valid", 96, 0, False, True, 32),
])
def test_build_schedule_matches_mmtpu(case):
    split, batch, epoch, shuffle, drop_last, base = case
    kw = dict(split=split, num_samples=40, selected_patterns=["ai", "a", "i"], seed=3)
    want = jax_dl.build_schedule(JaxSyntheticAVMNIST(**kw), batch, epoch, shuffle, 5, split,
                                 drop_last=drop_last, base_batch_size=base)
    got = dl.build_schedule(SyntheticAVMNIST(**kw), batch, epoch, shuffle, 5, split,
                            drop_last=drop_last, base_batch_size=base)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_gathered_batch_has_the_streaming_keys_and_rows():
    ds = SyntheticAVMNIST(split="valid", num_samples=40, selected_patterns=["ai", "a"], seed=1)
    loader = BatchLoader(ds, 32)
    sched = dl.build_schedule(ds, 32, 0, False, 0, "valid")
    data = dl.DeviceResidentData.upload(ds, CPU)
    on_device = dl.put_schedule(sched, CPU)
    for step, host in enumerate(loader):
        got = dl.gather_batch(data, on_device, step)
        assert set(got) == set(host)
        real = host["sample_mask"] > 0
        for key, want in host.items():
            np.testing.assert_array_equal(got[key].numpy()[real], want[real], err_msg=key)
            assert got[key].numpy().dtype == want.dtype, key
    assert dl.padded_steps(sched) == [False, False, True]


class TestResume:
    def _run(self, tmp_path, tag, epochs, resume=False):
        loop = port_loop("on", ckpt_dir=tmp_path / f"ckpt_{tag}", epochs=epochs,
                         metrics_path=tmp_path / f"metrics_{tag}", resume=resume, dropout=0.5)
        loop.run()
        return loop

    def test_resumed_equals_uninterrupted_on_the_resident_path(self, tmp_path):
        full = self._run(tmp_path, "full", 4)
        part = self._run(tmp_path, "part", 2)
        assert part._resident
        resumed = port_loop("on", ckpt_dir=part.ckpt.model_dir, epochs=4,
                            metrics_path=part.metrics_path, resume=True, dropout=0.5)
        resumed.run()
        for (n, p), q in zip(full.state.model.named_parameters(),
                             resumed.state.model.parameters()):
            torch.testing.assert_close(q, p, rtol=0, atol=0, msg=n)
        assert full.state.step == resumed.state.step == 12
        ea = json.loads((full.metrics_path / "epoch_metrics.json").read_text())
        eb = json.loads((resumed.metrics_path / "epoch_metrics.json").read_text())
        assert _strip_timing(ea) == _strip_timing(eb)


def test_test_restores_the_best_checkpoint_on_the_resident_path(tmp_path):
    """test() evaluates the best epoch's weights: the same metrics on the
    resident and the streaming path."""
    results = []
    for mode in ("off", "on"):
        loop = port_loop(mode, ckpt_dir=tmp_path / mode, epochs=2, lr_kind="exponential",
                         lr_args={"gamma": 0.5})
        loop.loaders["test"] = loop.loaders["validation"]
        if mode == "on":
            loop._admit("on", None)
            assert "test" in loop._resident
        loop.run()
        results.append(loop.test())
    np.testing.assert_allclose(results[1]["test"]["loss"], results[0]["test"]["loss"], rtol=1e-6)
    assert {k: v for k, v in results[0]["test"].items() if k != "loss"} == \
        {k: v for k, v in results[1]["test"].items() if k != "loss"}
