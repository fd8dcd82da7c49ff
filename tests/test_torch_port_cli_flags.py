"""The port's training-CLI flag surface against mmtpu's, on the CPU:

- every flag and alias of mmtpu's `standard_arg_parser` parses in the
  port's to the same `dest` and value;
- `derive_member_args` gives mmtpu's member namespaces, and the members'
  seeds (`finalize_config`'s offset) are mmtpu's;
- `--data-parallel`: 1 and -1 run on one device, N beyond the visible
  devices raises mmtpu's ValueError, any other N > 1 (DDP) raises
  NotImplementedError;
- `--stacked-folds` on a cross-validation config raises NotImplementedError;
- `monitoring.enabled: true` raises unless `--disable_monitoring`;
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
    with pytest.raises(ValueError, match="data_parallel=2 but only 1 devices visible"):
        _resolve(2)
    with pytest.raises(ValueError, match="use -1"):
        _resolve(-3)
    with pytest.raises(NotImplementedError, match="ROADMAP.md item 12"):
        _resolve(None, 2, devices=4, device="cuda", monkeypatch=monkeypatch)
    with pytest.raises(ValueError, match="only 4 devices"):
        _resolve(8, devices=4, device="cuda", monkeypatch=monkeypatch)


@pytest.mark.parametrize("module", ["train_multimodal", "train_monomodal"])
def test_data_parallel_two_raises_through_the_cli(module, tmp_path):
    src = "synthetic_runs.yaml" if module == "train_multimodal" else "synthetic_mono_audio.yaml"
    cfg = _config(tmp_path, src)
    with pytest.raises(ValueError, match="data_parallel=2 but only 1 devices visible"):
        run_cli_inproc(f"mmtpu_torch.cli.{module}", cfg, run_id="1",
                       extra=("--data-parallel", "2"))


def test_stacked_folds_raises_and_falls_back_as_mmtpu(tmp_path):
    from mmtpu_torch.cli import common, train_multimodal

    cfg_path = _config(tmp_path, "synthetic_cv.yaml")
    with pytest.raises(NotImplementedError, match="--stacked-folds.*ROADMAP.md item 12"):
        run_cli_inproc("mmtpu_torch.cli.train_multimodal", cfg_path, run_id="1",
                       extra=("--stacked-folds",))
    args = common.standard_arg_parser("x").parse_args(
        ["--config", str(cfg_path), "--stacked-folds", "--resume", "--cpu"])
    cfg = common.load_config(args)
    assert "--resume" in train_multimodal._stacked_fallback_reason(cfg, args)
    args.resume, args.data_parallel = False, -1
    assert "data_parallel=-1" in train_multimodal._stacked_fallback_reason(cfg, args)


def test_monitoring_enabled_raises_unless_disabled(tmp_path):
    cfg = _config(tmp_path, "synthetic_runs.yaml",
                  [("monitoring:\n  enabled: false", "monitoring:\n  enabled: true")])
    for module in ("train_multimodal", "train_avmnist"):
        with pytest.raises(NotImplementedError, match="monitor.*ROADMAP.md item 12"):
            run_cli_inproc(f"mmtpu_torch.cli.{module}", cfg, run_id="1", extra=("--dry-run",))
        assert run_cli_inproc(f"mmtpu_torch.cli.{module}", cfg, run_id="1",
                              extra=("--dry-run", "--disable_monitoring")) == 0


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
