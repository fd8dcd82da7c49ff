"""Monomodal pretraining of encoders that have no `hidden_dim`, both
packages' `train_monomodal` on the CPU, and the handoff into a fine-tune.

`MonomodalEncoder` sizes its head from the encoder's `get_embedding_size()`,
as mmtpu's lazily sized Dense takes it from its input. Tiny twins of three
pretrainings (dropout 0, 48/16/16 samples, batch 16, 2 epochs), each
package from mmtpu's initial weights:

- text on a TextCNN and audio on an LSTMEncoder, from
  configs/mosi/synthetic_utt_fusion.yaml (sequences of 10 steps);
- text on an MMIMDbModalityEncoder, from configs/mmimdb/synthetic_gmu.yaml.

Both exit 0, write `encoder_{mod}_best` and the same files, and every value
of their metrics JSON agrees at 1e-4. The port's handoffs then load into a
UttFusion fine-tune (netT and netA) and an MM-IMDb GMU fine-tune
(text_encoder) through `train_multimodal`, each encoder's state equal to
its file's.
"""

import json
import re
import shutil
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from mmtpu.cli import common as jax_common
from mmtpu_torch.checkpoints import from_jax_variables
from mmtpu_torch.cli import common

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _cli_harness import run_cli_inproc  # noqa: E402
from _torch_threads import few_threads  # noqa: E402,F401 — in-process comparisons only

REPO = Path(__file__).resolve().parent.parent
MOSI_YAML = REPO / "configs/mosi/synthetic_utt_fusion.yaml"
GMU_YAML = REPO / "configs/mmimdb/synthetic_gmu.yaml"
VALUE_TOL = 1e-4

TEXTCNN = """  text_encoder: !TextCNN
    input_size: 768
    embd_size: 16
    out_channels: 8
    dropout: 0.0"""
LSTM = """  audio_encoder: !LSTMEncoder
    input_size: 5
    hidden_size: 8
    embd_method: "maxpool\""""
MMIMDB_TEXT = """  text_encoder: !MMIMDbModalityEncoder
    input_dim: 300
    output_dim: 16"""

# name → (source config, model type, encoder block, modality)
PRETRAININGS = {
    "Tiny_MOSI_Text_Encoder": (MOSI_YAML, "utt-fusion", TEXTCNN, "text"),
    "Tiny_MOSI_Audio_Encoder": (MOSI_YAML, "utt-fusion", LSTM, "audio"),
    "Tiny_MMIMDb_Text_Encoder": (GMU_YAML, "MMIMDb", MMIMDB_TEXT, "text"),
}


def _twin(src: Path, root: Path, name: str, model: str) -> str:
    """`src` with `model` as its model section, the experiment renamed, the
    splits cut to 48/16/16 in batches of 16 (MOSI's sequences to 10 steps)
    and the outputs under `root`."""
    text = src.read_text()
    start, end = text.index("model: !ModelConfig"), text.index("\ntraining:")
    text = text[:start] + model + text[end:]
    text = re.sub(r'name: "[^"]*"', f'name: "{name}"', text, count=1)
    text = re.sub(r"batch_size: \d+", "batch_size: 16", text)
    counts = iter(("48", "16", "16"))
    text = re.sub(r"num_samples: \d+", lambda m: "num_samples: " + next(counts)
                  + ("\n        seq_len: 10" if src == MOSI_YAML else ""), text)
    return text.replace("./experiments_output", f"{root}/out")


def _mono_yaml(root: Path, name: str) -> Path:
    src, model_type, block, _ = PRETRAININGS[name]
    model = f'model: !ModelConfig\n  name: "{name}"\n  model_type: "{model_type}"\n{block}\n'
    path = root / f"{name}.yaml"
    path.write_text(_twin(src, root, name, model))
    return path


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' train_monomodal on each twin; the port from mmtpu's
    initial weights."""
    mp = pytest.MonkeyPatch()
    captured = {}
    real_state = jax_common.make_state

    def jax_make_state(model, params, batch_stats, training, clip=None):
        captured["v"] = jax.tree_util.tree_map(np.asarray, {"params": params,
                                                            "batch_stats": batch_stats})
        return real_state(model, params, batch_stats, training, clip=clip)

    def port_init(model, seed, device):
        v = captured["v"]
        model.load_state_dict(from_jax_variables(v["params"], v["batch_stats"], target=model),
                              strict=True)
        torch.manual_seed(int(seed))
        return model.to(device)

    out = {pkg: tmp_path_factory.mktemp(f"mono_{pkg}") for pkg in ("mmtpu", "mmtpu_torch")}
    try:
        mp.setattr(jax_common, "make_state", jax_make_state)
        mp.setattr(common, "init_model", port_init)
        for name in PRETRAININGS:
            for pkg, root in out.items():  # mmtpu first: its initial weights are the port's
                cfg = _mono_yaml(root, name)
                assert run_cli_inproc(f"{pkg}.cli.train_monomodal", cfg, run_id="1",
                                      cwd=root) == 0, (pkg, name)
    finally:
        mp.undo()
    yield out
    for root in out.values():
        shutil.rmtree(root, ignore_errors=True)


def _files(root: Path):
    return sorted(p.relative_to(root).as_posix().replace(".pth", "·").replace(".ckpt", "·")
                  for p in root.rglob("*") if p.is_file() and "/report/" not in p.as_posix())


def _values(obj, prefix=""):
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from _values(v, f"{prefix}/{k}")
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            yield from _values(v, f"{prefix}[{i}]")
    else:
        yield prefix, obj


@pytest.mark.parametrize("name", list(PRETRAININGS))
def test_pretraining_writes_mmtpus_files_and_handoff(runs, name):
    ours, theirs = (_files(runs[pkg] / "out" / name) for pkg in ("mmtpu_torch", "mmtpu"))
    assert ours == theirs
    mod = PRETRAININGS[name][3]
    assert f"models/1/encoder_{mod}_best·" in ours


@pytest.mark.parametrize("name", list(PRETRAININGS))
def test_pretraining_records_match_mmtpu(runs, name):
    metrics = sorted(p.relative_to(runs["mmtpu"] / "out").as_posix()
                     for p in (runs["mmtpu"] / "out" / name / "metrics").rglob("*.json"))
    assert metrics
    for rel in metrics:
        mine, theirs = (json.loads((runs[pkg] / "out" / rel).read_text())
                        for pkg in ("mmtpu_torch", "mmtpu"))
        a, b = list(_values(mine)), list(_values(theirs))
        assert [p for p, _ in a] == [p for p, _ in b], rel
        for (path, x), (_, y) in zip(a, b):
            if "/timing/" in path or path.endswith(("_time", "/time")):
                continue
            if isinstance(y, float):
                assert abs(x - y) <= VALUE_TOL * max(abs(y), 1.0), (rel, path, x, y)
            else:
                assert x == y, (rel, path, x, y)


def _handoff(runs, name):
    mod = PRETRAININGS[name][3]
    return runs["mmtpu_torch"] / "out" / name / "models/1" / f"encoder_{mod}_best.pth"


FINE_TUNES = {
    "utt_fusion": (MOSI_YAML, """model: !ModelConfig
  name: "UttFusion"
  model_type: "utt-fusion"
  netA: !LSTMEncoder {input_size: 5, hidden_size: 8, embd_method: "maxpool"}
  netV: !LSTMEncoder {input_size: 20, hidden_size: 8, embd_method: "maxpool"}
  netT: !TextCNN {input_size: 768, embd_size: 16, out_channels: 8, dropout: 0.0}
  netC: !FcClassifier {input_dim: 32, layers: [16], output_dim: 3, dropout: 0.0}
  clip: 0.5
  pretrained_encoders:
    text: "TEXT"
    audio: "AUDIO"
""", {"netT": "Tiny_MOSI_Text_Encoder", "netA": "Tiny_MOSI_Audio_Encoder"}),
    "mmimdb": (GMU_YAML, """model: !ModelConfig
  name: "MMIMDb"
  model_type: "MMIMDb"
  image_encoder: !MMIMDbModalityEncoder {input_dim: 4096, output_dim: 16}
  text_encoder: !MMIMDbModalityEncoder {input_dim: 300, output_dim: 16}
  gated_bimodal_network: !GatedBiModalNetwork
    {input_one_dim: 16, output_one_dim: 16, input_two_dim: 16, output_two_dim: 16}
  classifier: !MLPGenreClassifier {input_size: 16, hidden_size: 16, output_size: 23}
  pretrained_encoders:
    text: "TEXT"
""", {"text_encoder": "Tiny_MMIMDb_Text_Encoder"}),
}


@pytest.mark.parametrize("kind", list(FINE_TUNES))
def test_handoffs_load_into_the_fine_tune(runs, kind, tmp_path, monkeypatch):
    src, model, encoders = FINE_TUNES[kind]
    for attr, name in encoders.items():
        model = model.replace(PRETRAININGS[name][3].upper(), str(_handoff(runs, name)))
    name = f"Tiny_{kind}_Finetune"
    text = _twin(src, tmp_path, name, model).replace("epochs: 2", "epochs: 1")
    cfg = tmp_path / "finetune.yaml"
    cfg.write_text(text)
    loaded = {}
    real = common.load_pretrained_encoders

    def spy(model, pretrained, logging_cfg):
        out = real(model, pretrained, logging_cfg)
        for attr in encoders:
            loaded[attr] = {k: v.clone() for k, v in getattr(model, attr).state_dict().items()}
        return out

    monkeypatch.setattr(common, "load_pretrained_encoders", spy)
    assert run_cli_inproc("mmtpu_torch.cli.train_multimodal", cfg, run_id="1",
                          cwd=tmp_path) == 0
    for attr, src_name in encoders.items():
        want = torch.load(_handoff(runs, src_name), weights_only=True)
        assert set(loaded[attr]) == set(want), attr
        for k, v in want.items():
            assert torch.equal(loaded[attr][k], v), (attr, k)
    assert (tmp_path / "out" / name / "models/1/best.pth").exists()
