"""The port's training entry points against mmtpu's, end to end on the CPU:
monomodal audio pretraining → the pretrained late-fusion fine-tune
(`train_multimodal`, reference nesting) and the same through
`train_avmnist` (AVMNIST nesting), from the repo's synthetic configs cut to
a few dozen samples and LeNet encoders in their ResNets' place (what is held
here is the output API, which the encoders do not touch; the ResNets are
held against mmtpu in `tests/test_torch_port_models.py` and on the card).

The two packages draw different initial weights, so values differ; what is
held equal is the output API: the key structure of every metrics JSON
(values erased, as `test_golden_json_parity.structure` does), the file
names, and the checkpoint set under the port's `.pth` names. The port is
also held to itself: the handoff reaches the fine-tune unchanged, `predict`
on the run's `best.pth` gives the in-memory model's logits, and a run
resumed after epoch 1 of 2 ends where an uninterrupted run ends."""

import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
CONFIGS = REPO / "configs" / "avmnist"
MONO, MULTI, LATE = ("Synthetic_AVMNIST_Audio_Encoder", "Synthetic_AVMNIST_Multimodal_Pretrained",
                     "Synthetic_AVMNIST_Late_Fusion")

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _cli_harness import run_cli_inproc  # noqa: E402
from _torch_threads import few_threads  # noqa: E402,F401 — in-process comparisons only


def structure(obj):
    """Recursive key-structure signature (values erased)."""
    if isinstance(obj, dict):
        return {k: structure(v) for k, v in sorted(obj.items())}
    if isinstance(obj, list):
        return [structure(v) for v in obj]
    return "·"


def _tiny_config(src: str, dst: Path, out_root: Path, encoder_root: Path,
                 name: str = None) -> Path:
    """The repo's synthetic config with LeNet encoders of width 16 (audio)
    and 24 (image), a head of 32, 40 train and 24 eval samples in batches
    of 16 (so every split ends in a padded tail), outputs under `out_root`
    and the handoff read from `encoder_root`."""
    text = (CONFIGS / src).read_text()
    subs = [
        ('audio: "./experiments_output', f'audio: "{encoder_root}'),
        ("./experiments_output", str(out_root)),
        ("!ResNet34", "!LeNetEncoder"),
        ("!ResNet18", "!LeNetEncoder"),
        ("    hidden_dim: 128", "    hidden_dim: 24"),
        ("\n  hidden_dim: 128", "\n  hidden_dim: 32"),
        ("hidden_dim: 64", "hidden_dim: 16"),
        ("output_dim: 64", "output_dim: 16"),
        ("batch_size: 64", "batch_size: 16"),
        ("num_samples: 256", "num_samples: 40"),
        ("num_samples: 128", "num_samples: 24"),
        ("num_samples: 96", "num_samples: 24"),
    ]
    for old, new in subs:
        text = text.replace(old, new)
    if name is not None:
        text = text.replace(f'name: "{MULTI}"', f'name: "{name}"')
    dst.write_text(text)
    return dst


def _run(module, config, extra=()):
    assert run_cli_inproc(module, config, run_id="1", extra=extra) == 0


class _Spy:
    """Wraps the port's `load_pretrained_encoders`: keeps the model it was
    given (the run's in-memory model) and its audio encoder as loaded."""

    def __init__(self, monkeypatch):
        from mmtpu_torch.cli import common

        self.models, self.loaded = [], []
        real = common.load_pretrained_encoders

        def spy(model, pretrained, logging_cfg):
            out = real(model, pretrained, logging_cfg)
            self.models.append(model)
            self.loaded.append({k: v.clone() for k, v in model.audio_encoder.state_dict().items()})
            return out

        monkeypatch.setattr(common, "load_pretrained_encoders", spy)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """mono → multi → avmnist, once through mmtpu's CLIs and once through
    the port's; the port's multi run also with its in-memory model kept.
    The checkpoints (optimizer state included) are deleted when the
    module's tests are done."""
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        for pkg in ("mmtpu", "mmtpu_torch"):
            root = tmp_path_factory.mktemp(pkg)
            cfgs = {
                "mono": _tiny_config("synthetic_mono_audio.yaml", root / "mono.yaml", root, root),
                "multi": _tiny_config("synthetic_multimodal_pretrained.yaml", root / "multi.yaml",
                                      root, root),
                "late": _tiny_config("synthetic_multimodal_pretrained.yaml", root / "late.yaml",
                                     root, root, name=LATE),
            }
            spy = _Spy(mp) if pkg == "mmtpu_torch" else None
            _run(f"{pkg}.cli.train_monomodal", cfgs["mono"])
            _run(f"{pkg}.cli.train_multimodal", cfgs["multi"])
            _run(f"{pkg}.cli.train_avmnist", cfgs["late"])
            out[pkg] = {"root": root, "cfgs": cfgs, "spy": spy}
    finally:
        mp.undo()
    yield out
    for run in out.values():
        shutil.rmtree(run["root"], ignore_errors=True)


def _json_files(root: Path):
    return {p.relative_to(root).as_posix(): json.loads(p.read_text())
            for p in sorted(root.rglob("*.json")) if "/models/" not in p.as_posix()}


def test_metrics_json_files_and_key_structure_match_mmtpu(runs):
    """Every metrics JSON of the three runs (epoch_metrics.json in both
    nestings, the AVMNIST test entry under <metrics>/<run_id>/, and the
    {train,validation,test}_metrics.json records): same names, same keys."""
    ours = _json_files(runs["mmtpu_torch"]["root"])
    theirs = _json_files(runs["mmtpu"]["root"])
    assert sorted(ours) == sorted(theirs)
    for name in (f"{MONO}/metrics/1/epoch_metrics.json",
                 f"{MULTI}/metrics/1/test_metrics.json",
                 f"{LATE}/metrics/1/1/epoch_metrics.json"):
        assert name in ours
    for name, data in theirs.items():
        assert structure(ours[name]) == structure(data), name


def test_multimodal_test_entry_by_nesting(runs):
    """Reference nesting appends the test entry to epoch_metrics.json; the
    AVMNIST nesting writes it to <metrics>/<run_id>/epoch_metrics.json and
    nests every pattern-suffixed metric under its pattern."""
    root = runs["mmtpu_torch"]["root"]
    multi = json.loads((root / MULTI / "metrics/1/epoch_metrics.json").read_text())
    late = json.loads((root / LATE / "metrics/1/epoch_metrics.json").read_text())
    late_test = json.loads((root / LATE / "metrics/1/1/epoch_metrics.json").read_text())
    assert [set(e) for e in multi] == [{"epoch", "train", "validation"}] * 2 + [{"test"}]
    assert [set(e) for e in late] == [{"epoch", "train", "validation"}] * 2
    assert set(late_test[0]["test"]) == {"loss", "timing", "AI", "A", "I"}
    assert set(late[0]["validation"]["A"]) == {"accuracy", "f1_weighted"}


def _best_epochs(metrics_file: Path, early_stopping_cls):
    """The epochs whose validation loss was a new best by the package's
    own early-stopping rule: the ones that must have written epoch_N."""
    entries = [e for e in json.loads(metrics_file.read_text()) if "epoch" in e]
    stop = early_stopping_cls(patience=5, min_delta=0.001, mode="min", enabled=True)
    return [e["epoch"] for e in entries if stop.step(float(e["validation"]["loss"]))]


@pytest.mark.parametrize("run", [MONO, MULTI, LATE])
def test_checkpoint_set_matches_mmtpu(runs, run):
    from mmtpu.train.early_stopping import EarlyStopping as JaxEarlyStopping

    from mmtpu_torch.train.early_stopping import EarlyStopping

    def files(pkg, suffix, stopping):
        root = runs[pkg]["root"] / run
        best = _best_epochs(root / "metrics/1/epoch_metrics.json", stopping)
        names = sorted(p.name for p in (root / "models/1").iterdir())
        expect = {f"best{suffix}", "best.json", f"last{suffix}", "resume.json"}
        expect |= {f"epoch_{n}{s}" for n in best for s in (suffix, ".json")}
        if run == MONO:
            expect.add(f"encoder_audio_best{suffix}")
        assert set(names) == expect, (pkg, names)
        return {n.replace(suffix, "·") for n in names if not n.startswith("epoch_")}

    assert files("mmtpu_torch", ".pth", EarlyStopping) == files("mmtpu", ".ckpt",
                                                                  JaxEarlyStopping)


def test_handoff_reaches_the_fine_tune_unchanged(runs):
    """The fine-tune's audio encoder, as loaded before its first step, is
    the monomodal run's `encoder_audio_best.pth` (named `.ckpt` in the
    config), statistics included."""
    root, spy = runs["mmtpu_torch"]["root"], runs["mmtpu_torch"]["spy"]
    handoff = torch.load(root / MONO / "models/1/encoder_audio_best.pth", weights_only=True)
    assert len(spy.loaded) == 2  # the multi and the avmnist run
    for loaded in spy.loaded:
        assert set(loaded) == set(handoff)
        for k, v in handoff.items():
            assert torch.equal(loaded[k], v), k


def test_predict_on_best_gives_the_in_memory_models_logits(runs, tmp_path):
    """`cli.predict` restores `best.pth` (a training checkpoint: model,
    optimizer, step) and gives the logits of the model the run holds after
    its test phase restored the best epoch; its JSON's predictions are
    those logits' argmax."""
    import argparse

    from mmtpu_torch.cli import common, predict
    from mmtpu_torch.train.step import make_eval_step

    cfg_path = runs["mmtpu_torch"]["cfgs"]["multi"]
    model = runs["mmtpu_torch"]["spy"].models[0]
    cpu = torch.device("cpu")
    args = argparse.Namespace(config=str(cfg_path), run_id=1, seed=None, split="test",
                              checkpoint="best", cpu=True, out=str(tmp_path / "p.json"))
    cfg = common.load_config(args)
    task, loader = predict.build_task_and_loader(cfg, args, cpu)
    ours = make_eval_step(task, cpu)
    theirs = make_eval_step(type(task)(model=model.eval(), loss_group=task.loss_group,
                                       input_keys=task.input_keys), cpu)
    preds = []
    for batch in loader:
        a, b = ours(batch), theirs(batch)
        torch.testing.assert_close(a["logits"], b["logits"], rtol=0, atol=0)
        preds += b["preds"][b["sample_mask"] > 0].tolist()
    predict.run(args)
    records = json.loads(Path(args.out).read_text())["predictions"]
    assert [r["pred"] for r in records] == preds


def test_resume_after_one_epoch_ends_as_an_uninterrupted_run(runs, tmp_path):
    """--epochs 1, then --resume with the config's 2 epochs: the final
    weights, optimizer moments and BatchNorm statistics equal the
    uninterrupted run's, and so do the recorded epochs."""
    base = runs["mmtpu_torch"]["root"]
    cfg = _tiny_config("synthetic_multimodal_pretrained.yaml", tmp_path / "multi.yaml",
                       tmp_path, base)
    try:
        _run("mmtpu_torch.cli.train_multimodal", cfg, extra=("--epochs", "1"))
        _run("mmtpu_torch.cli.train_multimodal", cfg, extra=("--resume",))
        want = torch.load(base / MULTI / "models/1/last.pth", weights_only=True)
        got = torch.load(tmp_path / MULTI / "models/1/last.pth", weights_only=True)
    finally:
        shutil.rmtree(tmp_path / MULTI / "models", ignore_errors=True)
    assert got["step"] == want["step"] == 6
    for k, v in want["model"].items():
        torch.testing.assert_close(got["model"][k], v, rtol=0, atol=0, msg=k)
    for i, st in want["optimizer"]["state"].items():
        for k, v in st.items():
            torch.testing.assert_close(got["optimizer"]["state"][i][k], v, rtol=0, atol=0)
    epochs = [json.loads((r / MULTI / "metrics/1/epoch_metrics.json").read_text())
              for r in (base, tmp_path)]
    assert [e.get("epoch") for e in epochs[0]] == [e.get("epoch") for e in epochs[1]]
    losses = [[e["train"]["loss"] for e in run if "train" in e] for run in epochs]
    np.testing.assert_array_equal(losses[0], losses[1])


@pytest.mark.parametrize("module,src", [
    ("train_monomodal", "synthetic_mono_audio.yaml"),
    ("train_multimodal", "synthetic_multimodal_pretrained.yaml"),
    ("train_avmnist", "synthetic_multimodal_pretrained.yaml"),
])
def test_training_entry_points_raise_without_cuda_unless_asked_for_cpu(runs, module, src,
                                                                       monkeypatch, tmp_path):
    """No GPU and no --cpu: the entry point raises before it builds
    anything; with --cpu the same call builds config, data, model and state
    (--dry-run)."""
    import importlib

    mod = importlib.import_module(f"mmtpu_torch.cli.{module}")
    cfg = _tiny_config(src, tmp_path / src, tmp_path, runs["mmtpu_torch"]["root"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(["--config", str(cfg), "--run_id", "1"])
    assert not (tmp_path / MONO).exists() and not (tmp_path / MULTI).exists()
    assert mod.main(["--config", str(cfg), "--run_id", "1", "--cpu", "--dry-run"]) == 0
