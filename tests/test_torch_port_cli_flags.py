"""The port's training-CLI flag surface against mmtpu's, on the CPU:

- every flag and alias of mmtpu's `standard_arg_parser` parses in the
  port's to the same `dest` and value;
- `derive_member_args` gives mmtpu's member namespaces, and the members'
  seeds (`finalize_config`'s offset) are mmtpu's;
- `--data-parallel`: 1 and -1 run on one device, N beyond the visible
  devices raises mmtpu's ValueError, any other N > 1 resolves to a mesh of
  N ranks (`tests/test_torch_port_parallel*.py` train on it);
- `--stacked-folds` on a cross-validation config reaches the stacked engine,
  and falls back to sequential folds with `--resume` or data_parallel;
- `monitoring.enabled: true` writes the monitor's file unless `--disable_monitoring`;
- `--profile` writes a torch.profiler trace and `tensorboard_path` a
  tfevents file through `train_multimodal.main`.
"""

import argparse
import json
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
CONFIGS = REPO / "configs" / "avmnist"

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _cli_harness import run_cli_inproc  # noqa: E402


def _parsers():
    from mmtpu.cli import common as jax_common

    from mmtpu_torch.cli import common

    return common.standard_arg_parser("port"), jax_common.standard_arg_parser("mmtpu")


def test_every_mmtpu_flag_and_alias_parses_to_the_same_dest():
    ours, theirs = _parsers()
    for action in theirs._actions:
        for opt in action.option_strings:
            assert opt in ours._option_string_actions, opt
            mine = ours._option_string_actions[opt]
            assert (mine.dest, mine.default, mine.type, mine.nargs) == (
                action.dest, action.default, action.type, action.nargs), opt
    argv = ["--config", "x.yaml", "--run_id", "3", "--seed", "5", "--dry_run", "--skip-train",
            "--skip-test", "--disable-monitoring", "--cpu", "--data_parallel", "-1",
            "--profile", "--eval_batch_factor", "4", "--epochs", "2", "--resume",
            "--stacked_folds", "--stacked_runs", "3"]
    assert vars(ours.parse_args(argv)) == vars(theirs.parse_args(argv))
    # the spelling mmtpu's usage line shows (mmtpu/cli/train_multimodal.py:4)
    assert ours.parse_args(["--config", "x", "--disable_monitoring"]).disable_monitoring


@pytest.mark.parametrize("i", [0, 1, 3])
def test_member_args_and_seeds_match_mmtpu(i, tmp_path):
    from mmtpu.cli import common as jax_common

    from mmtpu_torch.cli import common

    ours, theirs = _parsers()
    cfg_path = _config(tmp_path, "synthetic_runs.yaml")
    argv = ["--config", str(cfg_path), "--run_id", "4", "--stacked-runs", "4", "--cpu"]
    mine = common.derive_member_args(ours.parse_args(argv), 4, i)
    want = jax_common.derive_member_args(theirs.parse_args(argv), 4, i)
    assert vars(mine) == vars(want)
    assert (mine.run_id, mine.seed_offset, mine.stacked_runs) == (4 + i, i, 0)
    seeds = [c.experiment.seed for c in (common.load_config(mine),
                                         jax_common.load_config(want))]
    assert seeds == [11 + i] * 2


def _config(tmp_path, src, edits=()):
    """A repo config with its outputs under tmp_path."""
    text = (CONFIGS / src).read_text().replace('"experiments_output', f'"{tmp_path}/out')
    for old, new in edits:
        assert old in text, old
        text = text.replace(old, new)
    dst = tmp_path / src
    dst.write_text(text)
    return dst


def _resolve(dp_flag=None, dp_config=None, devices=1, device="cpu", monkeypatch=None):
    from mmtpu_torch.cli import common

    cfg = argparse.Namespace(experiment=argparse.Namespace(data_parallel=dp_config))
    if monkeypatch is not None:
        monkeypatch.setattr(torch.cuda, "device_count", lambda: devices)
    return common.resolve_mesh(cfg, argparse.Namespace(data_parallel=dp_flag),
                               torch.device(device))


def test_data_parallel_rules(monkeypatch):
    for dp in (None, 0, 1, -1):
        assert _resolve(dp) is None and _resolve(None, dp) is None
    assert _resolve(2).world_size == 2  # on the CPU each rank is a process
    with pytest.raises(ValueError, match="data_parallel=2 but only 1 devices visible"):
        _resolve(2, devices=1, device="cuda", monkeypatch=monkeypatch)
    with pytest.raises(ValueError, match="use -1"):
        _resolve(-3)
    mesh = _resolve(None, 2, devices=4, device="cuda", monkeypatch=monkeypatch)
    assert mesh.world_size == 2 and not mesh.launched
    assert mesh.devices == [torch.device("cuda", 0), torch.device("cuda", 1)]
    with pytest.raises(ValueError, match="only 4 devices"):
        _resolve(8, devices=4, device="cuda", monkeypatch=monkeypatch)


@pytest.mark.parametrize("module", ["train_multimodal", "train_monomodal"])
def test_data_parallel_two_raises_through_the_cli(module, tmp_path, monkeypatch):
    """On the GPU (one card, the count monkeypatched) N = 2 raises mmtpu's
    ValueError before a rank starts; on the CPU each rank is a process, so
    `--cpu --data-parallel 2` trains (tests/test_torch_port_parallel_cli.py)."""
    import importlib

    src = "synthetic_runs.yaml" if module == "train_multimodal" else "synthetic_mono_audio.yaml"
    cfg = _config(tmp_path, src)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    main = importlib.import_module(f"mmtpu_torch.cli.{module}").main
    with pytest.raises(ValueError, match="data_parallel=2 but only 1 devices visible"):
        main(["--config", str(cfg), "--run_id", "1", "--data-parallel", "2"])


def test_stacked_folds_raises_and_falls_back_as_mmtpu(tmp_path, monkeypatch):
    """--stacked-folds reaches the stacked engine (it raised before the
    engine was ported); with --resume or data_parallel it falls back to
    sequential folds, as mmtpu does."""
    from mmtpu_torch.cli import common, stacked_cv, train_multimodal

    cfg_path = _config(tmp_path, "synthetic_cv.yaml")
    reached = []
    monkeypatch.setattr(stacked_cv, "run", lambda cfg, args, device, json_nesting:
                        reached.append(int(cfg.experiment.cross_validation)) or 0)
    assert run_cli_inproc("mmtpu_torch.cli.train_multimodal", cfg_path, run_id="1",
                          extra=("--stacked-folds",)) == 0
    assert reached == [2]
    args = common.standard_arg_parser("x").parse_args(
        ["--config", str(cfg_path), "--stacked-folds", "--resume", "--cpu"])
    cfg = common.load_config(args)
    assert "--resume" in train_multimodal._stacked_fallback_reason(cfg, args)
    args.resume, args.data_parallel = False, -1
    assert "data_parallel=-1" in train_multimodal._stacked_fallback_reason(cfg, args)


def test_monitoring_enabled_raises_unless_disabled(tmp_path):
    """`monitoring.enabled: true` with a `monitor_path` writes
    `<monitor_path>/monitor_data.h5` (it raised before the monitor was
    ported); `--disable_monitoring` writes none."""
    import h5py

    cfg = _config(tmp_path, "synthetic_runs.yaml", [
        ("monitoring:\n  enabled: false", "monitoring:\n  enabled: true"),
        ('  save_metric: "loss"',
         f'  save_metric: "loss"\n  monitor_path: "{tmp_path}/monitor/{{run_id}}"')])
    for run_id, module in (("1", "train_multimodal"), ("2", "train_avmnist")):
        assert run_cli_inproc(f"mmtpu_torch.cli.{module}", cfg, run_id=run_id,
                              extra=("--epochs", "1")) == 0
        with h5py.File(tmp_path / "monitor" / run_id / "monitor_data.h5", "r") as f:
            assert sorted(f) == ["activations", "convergence", "gradients", "weights"]
            assert "epoch_1" in f["weights"] and "epoch_1/step_0" in f["gradients"]
        # a dry run builds the monitor, so it opens the file unless disabled
        assert run_cli_inproc(f"mmtpu_torch.cli.{module}", cfg, run_id="3",
                              extra=("--dry-run", "--disable_monitoring")) == 0
        assert not (tmp_path / "monitor" / "3" / "monitor_data.h5").exists()


def test_profile_and_tensorboard_through_the_cli(tmp_path):
    cfg = _config(tmp_path, "synthetic_runs.yaml", [(
        '  save_metric: "loss"',
        f'  save_metric: "loss"\n  tensorboard_path: "{tmp_path}/tb/{{run_id}}"\n'
        '  tb_record_only: ["accuracy_AI"]')])
    assert run_cli_inproc("mmtpu_torch.cli.train_multimodal", cfg, run_id="2",
                          extra=("--profile", "--epochs", "1", "--eval-batch-factor", "4")) == 0
    trace = tmp_path / "out/Synthetic_Runs/logs/2/profile/trace.json"
    assert trace.stat().st_size > 0 and json.loads(trace.read_text())["traceEvents"]
    (events,) = (tmp_path / "tb/2").glob("events.out.tfevents.*")
    payload = events.read_bytes()
    assert payload.count(b"classification_accuracy_AI") == 2  # train and validation, epoch 1
    # accuracy_A, which `accuracy_AI` does not match, is left out (in the
    # file its tag would be followed by the value's key byte 0x15)
    assert b"accuracy_A\x15" not in payload and b"loss" not in payload
