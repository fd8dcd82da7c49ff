"""IEMOCAP in the port against mmtpu, on the CPU.

- The reader (`mmtpu_torch/data/iemocap.py`) on files this test writes in
  the layout of scripts/make_synthetic_iemocap.py (`A/comparE.h5` with the
  folds' mean and std, `V/denseface.h5`, `T/bert_large.h5`,
  `target/{cv}/{split}_{label,int2name}.npy`) at tiny widths: labels,
  every modality's padded array and its lengths bit for bit with mmtpu's,
  under the `trn` and `utt` norms, a std of 0 in the fold's statistics,
  utterances longer than `max_len`, and `int2name` stored as bytes, as
  1-element arrays and as str. The padded length is each split's and each
  modality's own longest utterance.
- `resolve_dataset_name`: "iemocap" is the port's reader; "msp_improv"
  raises mmtpu's `NotImplementedError`.
- The 10-fold cross-validation cut to 2 folds: both packages' `train_multimodal` on
  a tiny UttFusion YAML over those files (a pattern-qualified `save_metric`,
  `F1_Macro_ATV`, and the ch3 configs' `lambda` scheduler string), the port
  from mmtpu's initial weights fold by fold: the same files, the same JSON
  keys, and every value of the per-fold records and of the
  `{train,validation,test}_metrics_agg.json` within 1e-4.
"""

import json
import shutil
import sys
from pathlib import Path

import h5py
import jax
import numpy as np
import pytest
import torch

from mmtpu.cli import common as jax_common
from mmtpu.data import resolve_dataset_name as jax_resolve
from mmtpu_torch.checkpoints import from_jax_variables
from mmtpu_torch.cli import common
from mmtpu_torch.data import IEMOCAP, resolve_dataset_name
from mmtpu_torch.data import iemocap as port_iemocap

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _cli_harness import run_cli_inproc  # noqa: E402
from _torch_threads import few_threads  # noqa: E402,F401 — in-process comparisons only

DIMS = {"A": ("comparE", 6), "V": ("denseface", 5), "T": ("bert_large", 8)}
SPLITS = {"trn": 16, "val": 8, "tst": 8}
VALUE_TOL = 1e-4
NAME = "Tiny_IEMOCAP_UttFusion_CV"


def write_iemocap(root: Path, folds: int = 2, int2name: str = "str", max_t: int = 12,
                  seed: int = 0) -> Path:
    """Features and fold files in the generator's layout. Frame counts run
    3..max_t; the fold statistics have a nonzero mean and a std with zeros.
    `int2name` is stored as "str", "bytes" or "array" (1-element rows)."""
    g = np.random.default_rng(seed)
    n = sum(SPLITS.values())
    names = [f"Ses{i // 1000:02d}F_{i:05d}" for i in range(n)]
    for sub, (kind, dim) in DIMS.items():
        (root / sub).mkdir(parents=True, exist_ok=True)
        with h5py.File(root / sub / f"{kind}.h5", "w") as f:
            for name in names:
                f[name] = (2.0 * g.normal(size=(int(g.integers(3, max_t + 1)), dim))
                           + 0.5).astype(np.float32)
    with h5py.File(root / "A" / "comparE_mean_std.h5", "w") as f:
        for cv in range(1, folds + 1):
            std = g.uniform(0.5, 2.0, DIMS["A"][1]).astype(np.float32)
            std[cv % DIMS["A"][1]] = 0.0
            f[f"{cv}/mean"] = g.normal(size=DIMS["A"][1]).astype(np.float32)
            f[f"{cv}/std"] = std
    labels = g.integers(0, 4, n)
    for cv in range(1, folds + 1):
        tgt = root / "target" / str(cv)
        tgt.mkdir(parents=True, exist_ok=True)
        order = np.random.default_rng((seed, cv)).permutation(n)
        start = 0
        for split, count in SPLITS.items():
            idx = order[start:start + count]
            start += count
            np.save(tgt / f"{split}_label.npy", np.eye(4, dtype=np.float32)[labels[idx]])
            chosen = [names[i] for i in idx]
            stored = {"str": np.array(chosen),
                      "bytes": np.array([c.encode() for c in chosen]),
                      "array": np.array([[c.encode()] for c in chosen])}[int2name]
            np.save(tgt / f"{split}_int2name.npy", stored)
    return root


@pytest.mark.parametrize("split", ["train", "valid", "test"])
@pytest.mark.parametrize("norm", ["trn", "utt"])
@pytest.mark.parametrize("int2name", ["str", "bytes", "array"])
def test_reader_matches_mmtpu_bit_for_bit(tmp_path, int2name, norm, split):
    root = write_iemocap(tmp_path, int2name=int2name)
    kw = dict(cv_no=2, norm_method=norm, max_len=9)
    theirs = jax_resolve("iemocap")(str(root), split, **kw)
    mine = resolve_dataset_name("iemocap")(str(root), split, **kw)
    assert type(mine) is IEMOCAP
    assert mine.labels.dtype == np.int64
    np.testing.assert_array_equal(mine.labels, theirs.labels)
    assert [str(m) for m in mine.arrays] == [str(m) for m in theirs.arrays]
    assert [str(m) for m in mine.lengths] == [str(m) for m in theirs.lengths]
    for (m, a), b, n, k in zip(mine.arrays.items(), theirs.arrays.values(),
                               mine.lengths.values(), theirs.lengths.values()):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape, m
        assert a.tobytes() == b.tobytes(), m
        assert n.dtype == k.dtype and n.tobytes() == k.tobytes(), m
        assert a.shape[1] == min(int(n.max()), 9)
    assert mine.selected_patterns == theirs.selected_patterns
    assert mine.num_samples == {"train": 16, "valid": 8, "test": 8}[split]
    assert np.isfinite(mine.arrays[next(iter(mine.arrays))]).all()


def test_padded_length_is_each_splits_and_modalitys_own(tmp_path):
    """Below `max_len` the padded length follows the split's longest
    utterance per modality, so modalities and splits may differ in T."""
    root = write_iemocap(tmp_path, max_t=12)
    shapes = {s: {str(m): a.shape[1] for m, a in IEMOCAP(str(root), s, max_len=64).arrays.items()}
              for s in ("train", "valid", "test")}
    for s, per_mod in shapes.items():
        ds = IEMOCAP(str(root), s, max_len=64)
        for m, arr in ds.arrays.items():
            assert arr.shape[1] == int(ds.lengths[m].max()), (s, m)
    assert len({t for per_mod in shapes.values() for t in per_mod.values()}) > 1


def test_assemble_without_files():
    """The assembling step alone (what a caller without h5py feeds): the
    fold's statistics, std already 1 where it was 0, and the crop."""
    from mmtpu_torch.modalities import Modality

    g = np.random.default_rng(0)
    feats = {Modality.AUDIO: [g.normal(size=(t, 3)).astype(np.float32) for t in (2, 5, 4)],
             Modality.TEXT: [g.normal(size=(t, 2)).astype(np.float32) for t in (1, 1, 3)]}
    mean, std = np.ones(3, np.float32), np.full(3, 2.0, np.float32)
    arrays, lengths = port_iemocap.assemble(feats, mean, std, "trn", max_len=4)
    assert arrays[Modality.AUDIO].shape == (3, 4, 3) and arrays[Modality.TEXT].shape == (3, 3, 2)
    assert lengths[Modality.AUDIO].tolist() == [2, 4, 4]
    np.testing.assert_array_equal(arrays[Modality.AUDIO][1], (feats[Modality.AUDIO][1][:4] - 1) / 2)
    assert not arrays[Modality.AUDIO][0, 2:].any()


def test_cv_no_and_other_datasets():
    with pytest.raises(ValueError, match="1..10"):
        IEMOCAP("unused", "train", cv_no=11)
    for resolve in (resolve_dataset_name, jax_resolve):
        with pytest.raises(NotImplementedError, match="msp_improv is an empty stub"):
            resolve("msp_improv")
        with pytest.raises(ValueError, match="Unknown dataset: nope"):
            resolve("nope")


# -- cross-validation, both packages -------------------------------------------------

def _split(name: str, split: str, root: Path, patterns: str, missing: float) -> str:
    return f"""    {name}: !DatasetConfig
      dataset: "iemocap"
      data_fp: "{root}"
      split: "{split}"
      target_modality: !Modality "MULTIMODAL"
      batch_size: 8{chr(10) + '      shuffle: true' if split == 'train' else ''}
      kwargs:
        norm_method: "trn"
        max_len: 10
      missing_patterns: !MissingPatternConfig
        modalities:
          !Modality audio: !ModalityConfig
            missing_rate: {missing}
          !Modality video: !ModalityConfig
            missing_rate: {missing}
          !Modality text: !ModalityConfig
            missing_rate: 0.0
        selected_patterns: {patterns}"""


def cv_yaml(path: Path, data: Path, out: Path) -> Path:
    """A tiny twin of the IEMOCAP UttFusion CV run: 2 folds, LSTMs 6→8 and
    5→8 (maxpool), TextCNN 8→8, classifier 24→[8]→4, dropout 0."""
    splits = "\n".join([
        _split("train", "train", data, '["atv"]', 0.2),
        _split("validation", "valid", data, '["atv", "at", "av", "tv", "a", "t", "v"]', 0.0),
        _split("test", "test", data, '["atv", "at", "av", "tv", "a", "t", "v"]', 0.0)])
    path.write_text(f"""!StandardConfig
experiment: !ExperimentConfig
  name: "{NAME}"
  seed: 42
  device: "tpu"
  is_train: true
  is_test: true
  cross_validation: 2

model: !ModelConfig
  name: "UttFusion"
  model_type: "utt-fusion"
  netA: !LSTMEncoder {{input_size: 6, hidden_size: 8, embd_method: "maxpool"}}
  netV: !LSTMEncoder {{input_size: 5, hidden_size: 8, embd_method: "maxpool"}}
  netT: !TextCNN {{input_size: 8, embd_size: 8, out_channels: 4, dropout: 0.0}}
  netC: !FcClassifier {{input_dim: 24, layers: [8], output_dim: 4, dropout: 0.0}}

training:
  epochs: 2
  early_stopping: false
  num_modalities: 3
  optimizer: !Optimizer
    name: "Adam"
    default_kwargs: {{lr: 0.001, eps: 0.001}}
  scheduler: "lambda"
  scheduler_args:
    lr_lambda: "lambda epoch: 1.0 - max(0, epoch + epoch_count - niter) / float(niter_decay + 1)"
    epoch_count: 1
    niter: 1
    niter_decay: 1
  loss_functions: !LossFunctionGroup
    cross_entropy: {{loss_name: "cross_entropy", loss_args: {{}}, weight: 1.0}}

data: !DataConfig
  datasets:
{splits}

metrics:
  metrics:
    F1_Macro:
      function: "sklearn.metrics.f1_score"
      kwargs: {{average: "macro", zero_division: 0}}
    accuracy:
      function: "sklearn.metrics.accuracy_score"
      kwargs: {{}}
  groups:
    classification: ["F1_Macro", "accuracy"]

logging:
  log_path: "{out}/{{experiment_name}}/logs/{{run_id}}"
  model_output_path: "{out}/{{experiment_name}}/models/{{run_id}}"
  metrics_path: "{out}/{{experiment_name}}/metrics/{{run_id}}"
  save_metric: "F1_Macro_ATV"

monitoring:
  enabled: false
""")
    return path


@pytest.fixture(scope="module")
def cv_runs(tmp_path_factory):
    """mmtpu's CV, then the port's from mmtpu's initial weights fold by fold."""
    data = write_iemocap(tmp_path_factory.mktemp("iemocap_data"))
    mp = pytest.MonkeyPatch()
    out, inits = {}, []
    real_jax_init = jax_common.init_model

    def jax_spy(model, sample, seed):
        params, stats = real_jax_init(model, sample, seed)
        inits.append(jax.tree_util.tree_map(np.asarray, params))
        return params, stats

    def port_init(model, seed, device):
        model.load_state_dict(from_jax_variables(inits.pop(0), target=model), strict=True)
        torch.manual_seed(int(seed))
        return model.to(device)

    try:
        mp.setattr(jax_common, "init_model", jax_spy)
        mp.setattr(common, "init_model", port_init)
        for pkg in ("mmtpu", "mmtpu_torch"):
            root = tmp_path_factory.mktemp(f"iemocap_{pkg}")
            cfg = cv_yaml(root / "cv.yaml", data, root / "out")
            assert run_cli_inproc(f"{pkg}.cli.train_multimodal", cfg, run_id="1") == 0
            out[pkg] = root / "out" / NAME
        assert not inits
    finally:
        mp.undo()
    yield out
    for root in out.values():
        shutil.rmtree(root.parent.parent, ignore_errors=True)


def _files(root: Path):
    return sorted(p.relative_to(root).as_posix().replace(".ckpt", ".·").replace(".pth", ".·")
                  for p in root.rglob("*") if p.is_file())


def _values(obj, prefix=""):
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from _values(v, f"{prefix}/{k}")
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            yield from _values(v, f"{prefix}[{i}]")
    else:
        yield prefix, obj


def test_cv_writes_mmtpus_files(cv_runs):
    def without_epochs(files):  # the epoch checkpoints a run keeps follow its own F1s
        return [f for f in files if "/epoch_" not in f]

    ours, theirs = (without_epochs(_files(cv_runs[p])) for p in ("mmtpu_torch", "mmtpu"))
    assert ours == theirs
    for name in ("fold_1/test_metrics.json", "fold_2/validation_metrics.json",
                 "train_metrics_agg.json", "validation_metrics_agg.json",
                 "test_metrics_agg.json"):
        assert f"metrics/1/{name}" in ours
    assert "models/1/fold_2/best.·" in ours


@pytest.mark.parametrize("name", [
    "train_metrics_agg.json", "validation_metrics_agg.json", "test_metrics_agg.json",
    "fold_1/train_metrics.json", "fold_1/validation_metrics.json", "fold_1/test_metrics.json",
    "fold_2/train_metrics.json", "fold_2/validation_metrics.json", "fold_2/test_metrics.json",
    "fold_2/epoch_metrics.json"])
def test_cv_records_match_mmtpu(cv_runs, name):
    """Keys, their order and every value at 1e-4 (times excepted)."""
    ours, theirs = (json.loads((cv_runs[p] / "metrics/1" / name).read_text())
                    for p in ("mmtpu_torch", "mmtpu"))
    a, b = list(_values(ours)), list(_values(theirs))
    assert [p for p, _ in a] == [p for p, _ in b]
    checked = 0
    for (path, x), (_, y) in zip(a, b):
        if "time" in path:
            continue
        if isinstance(y, float):
            assert abs(x - y) <= VALUE_TOL * max(abs(y), 1.0), (path, x, y)
            checked += 1
        else:
            assert x == y, (path, x, y)
    assert checked
    if name.endswith("_agg.json"):
        keys = set(ours[0])
        assert {"loss", "F1_Macro_ATV", "accuracy_ATV"} <= keys, keys
        assert ("accuracy_V" in keys) == (not name.startswith("train")), keys
