"""The MM-IMDb chain through both packages' CLIs on the CPU: the text
pretraining, the repo's own configs/mmimdb_pretrained_text_only.yaml
unedited on top of it, and C-MAM image → text over that fine-tune.

`EXP_PATH` points at a tmp tree per package that holds tiny
`DATA/mmimdb/{train,validation,test}.hdf5` splits written with h5py
(`vgg_features` 4096, `features` 300, `genres` 23, `imdb_ids`; 40 / 16 / 16
rows), and each command runs from that tree, since the config names its
text encoder by the relative path
`experiments_output/MMIMDb_Text_Encoder_Pretrain/models/1/encoder_text_best.pth`:

1. `train_monomodal` on a twin of the config with the text encoder alone
   (MMIMDbModalityEncoder 300→512, the experiment named as that path
   wants) writes the handoff. mmtpu's monomodal task takes the argmax of
   the multilabel head, so its F1s fail and are logged; the port does the
   same (a divergence from the reference kept on purpose).
2. `train_multimodal --epochs 2` on the config as it is (published GMU
   widths, batch 128, `encoder_optimizer` at lr 1e-6 beside the default
   1e-5, `save_metric: loss`).
3. `train_cmam --epochs 2 --export-serving` on a C-MAM YAML this test
   writes over step 2's best checkpoint: MMIMDbModalityEncoder 4096→512 for
   the image (copied from the base), an AssociationNetwork 512→256→512
   with BatchNorm and dropout 0 (chosen here; the reference's
   image_to_text.yaml is not in the repository), the `cmam` loss without
   its classification term, the four F1s and mae / mse / cosine.

Every stage of the port starts from mmtpu's initial weights for it; the
classifier's hard-coded dropout 0.5 is neutralised in both packages. Held:
the same files; every value of every metrics JSON within 1e-4; the
optimizer groups each package reports; the port's fine-tune text encoder
equal to its file bit for bit; the C-MAM record keys, nested groups
included, equal to tests/golden/reference_cmam's; the artifact's meta and
its answers at a batch size the export never saw.
"""

import json
import re
import shutil
import sys
from pathlib import Path

import h5py
import jax
import numpy as np
import pytest
import torch

from mmtpu.cli import common as jax_common
from mmtpu.models import mmimdb as jax_mmimdb
from mmtpu_torch.checkpoints import from_jax_variables
from mmtpu_torch.cli import common
from mmtpu_torch.models import rng as port_rng
from mmtpu_torch.train import optim as port_optim

REPO = Path(__file__).resolve().parent.parent
CONFIG = REPO / "configs/mmimdb_pretrained_text_only.yaml"
GOLDEN = REPO / "tests/golden/reference_cmam"
sys.path.insert(0, str(Path(__file__).resolve().parent))
from _cli_harness import run_cli_inproc  # noqa: E402
from _redcore_neutral import _NoDropoutLinen  # noqa: E402

PRETRAIN = "MMIMDb_Text_Encoder_Pretrain"
CMAM = "MM_IMDb_C_MAM_Image_To_Text"
HANDOFF = f"experiments_output/{PRETRAIN}/models/1/encoder_text_best.pth"
VALUE_TOL = 1e-4
ROWS = {"train": 40, "validation": 16, "test": 16}


def write_mmimdb(root: Path) -> None:
    g = np.random.default_rng(5)
    d = root / "DATA/mmimdb"
    d.mkdir(parents=True, exist_ok=True)
    for split, n in ROWS.items():
        genres = (g.random((n, 23)) < 0.2).astype(np.float32)
        with h5py.File(d / f"{split}.hdf5", "w") as f:
            f["vgg_features"] = (g.normal(size=(n, 4096)) + genres @ g.normal(
                size=(23, 4096))).astype(np.float32)
            f["features"] = (g.normal(size=(n, 300)) + genres @ g.normal(
                size=(23, 300))).astype(np.float32)
            f["genres"] = genres
            f["imdb_ids"] = np.array([f"{i:07d}".encode() for i in range(n)])


def pretrain_yaml(root: Path) -> Path:
    """The config with its model cut to the text encoder."""
    text = CONFIG.read_text()
    start, end = text.index("model: !ModelConfig"), text.index("\ntraining:")
    text = text[:start] + f"""model: !ModelConfig
  name: "{PRETRAIN}"
  model_type: "MMIMDb"
  text_encoder: !MMIMDbModalityEncoder
    input_dim: 300
    output_dim: 512
""" + text[end:]
    text = text.replace('name: "mm_imdb Pretrained TextOnly Training"', f'name: "{PRETRAIN}"')
    path = root / "pretrain.yaml"
    path.write_text(text)
    return path


def _split(name, split):
    return f"""    {name}: !DatasetConfig
      dataset: "mm_imdb"
      data_fp: "$EXP_PATH/DATA/mmimdb/{name}.hdf5"
      split: "{split}"
      target_modality: !Modality "MULTIMODAL"
      batch_size: 16
      missing_patterns: !MissingPatternConfig
        modalities:
          !Modality text: !ModalityConfig
            missing_rate: 0.0
          !Modality image: !ModalityConfig
            missing_rate: 0.0
        selected_patterns: ["it"]"""


def cmam_yaml(root: Path, base_dir: Path) -> Path:
    """C-MAM image → text over the fine-tune's best checkpoint."""
    model = CONFIG.read_text()
    model = model[model.index("model: !ModelConfig"):model.index("\ntraining:")]
    model = re.sub(r"  pretrained_encoders:\n    text: [^\n]*\n", "", model)
    model = re.sub(r"  # [^\n]*\n", "", model)
    path = root / "cmam.yaml"
    path.write_text(f"""!CMAMConfig
experiment: !ExperimentConfig
  name: "{CMAM}"
  seed: 42
  device: "cuda"
  is_train: true
  is_test: true

{model.rstrip()}
  pretrained_path: "{base_dir}/models/{{run_id}}/best.ckpt"

cmam: !ModelConfig
  name: "CMAM"
  model_type: "CMAM"
  target_modality: !Modality text
  load_pretrained_encoder_state_for: ["image"]
  input_encoders: !InputEncoders
    !Modality image: !MMIMDbModalityEncoder
      input_dim: 4096
      output_dim: 512
  association_network: !AssociationNetwork
    input_size: 512
    hidden_size: 256
    output_size: 512
    dropout: 0.0
    batch_norm: True

target_modality: text

training:
  epochs: 2
  early_stopping: false
  num_modalities: 2
  optimizer: !Optimizer
    name: "Adam"
    default_kwargs: {{lr: 0.001, weight_decay: 0.0001, eps: 0.001}}
  loss_functions: !LossFunctionGroup
    cmam:
      loss_name: "cmam"
      loss_kwargs: {{cosine_weight: 1.0, mae_weight: 1.0, mse_weight: 1.0, cls_weight: 0.0}}
      weight: 1.0

data: !DataConfig
  datasets:
{_split("train", "train")}
{_split("validation", "valid")}
{_split("test", "test")}

metrics:
  metrics:
    f1_samples: {{function: "sklearn.metrics.f1_score", kwargs: {{average: "samples", zero_division: 0}}}}
    f1_macro: {{function: "sklearn.metrics.f1_score", kwargs: {{average: "macro", zero_division: 0}}}}
    f1_weighted: {{function: "sklearn.metrics.f1_score", kwargs: {{average: "weighted", zero_division: 0}}}}
    f1_micro: {{function: "sklearn.metrics.f1_score", kwargs: {{average: "micro", zero_division: 0}}}}
    mae: {{function: "sklearn.metrics.mean_absolute_error", kwargs: {{}}}}
    mse: {{function: "sklearn.metrics.mean_squared_error", kwargs: {{}}}}
    cosine: {{function: "metrics.cosine_similarity", kwargs: {{}}}}
  groups:
    classification: ["f1_samples", "f1_macro", "f1_weighted", "f1_micro"]
    reconstruction: ["mae", "mse", "cosine"]

logging:
  log_path: "$EXP_PATH/experiments_output/{{experiment_name}}/logs/{{run_id}}"
  model_output_path: "$EXP_PATH/experiments_output/{{experiment_name}}/models/{{run_id}}"
  metrics_path: "$EXP_PATH/experiments_output/{{experiment_name}}/metrics/{{run_id}}"
  save_metric: "loss"

monitoring:
  enabled: false
""")
    return path


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """Both packages through the three stages, mmtpu first; the port's
    stages from mmtpu's initial weights (by model class)."""
    mp = pytest.MonkeyPatch()
    captured, reports, loaded = {}, {}, {}
    real_state, real_build = jax_common.make_state, jax_common.build_optimizer
    real_port_build, real_load = port_optim.build_optimizer, common.load_pretrained_encoders

    def jax_make_state(model, params, batch_stats, training, clip=None):
        captured[type(model).__name__] = jax.tree_util.tree_map(
            np.asarray, {"params": params, "batch_stats": batch_stats})
        return real_state(model, params, batch_stats, training, clip=clip)

    def port_init(model, seed, device):
        v = captured[type(model).__name__]
        model.load_state_dict(from_jax_variables(v["params"], v["batch_stats"], target=model),
                              strict=True)
        torch.manual_seed(int(seed))
        return model.to(device)

    def spy_build(pkg, real):
        def build(config, params_or_model, extra_groups=None, **kw):
            tx, report = real(config, params_or_model, extra_groups=extra_groups, **kw)
            reports.setdefault(pkg, []).append((report, tx))
            return tx, report
        return build

    def port_load(model, pretrained, logging_cfg):
        out = real_load(model, pretrained, logging_cfg)
        if pretrained:
            loaded.update({k: v.clone() for k, v in model.text_encoder.state_dict().items()})
        return out

    out = {}
    try:
        mp.setattr(jax_common, "make_state", jax_make_state)
        mp.setattr(jax_common, "build_optimizer", spy_build("mmtpu", real_build))
        mp.setattr(port_optim, "build_optimizer", spy_build("mmtpu_torch", real_port_build))
        mp.setattr(common, "init_model", port_init)
        mp.setattr(common, "load_pretrained_encoders", port_load)
        mp.setattr(jax_mmimdb, "nn", _NoDropoutLinen("flax.linen"))
        mp.setattr(port_rng.GeneratorDropout, "forward", lambda self, x: x)
        for pkg in ("mmtpu", "mmtpu_torch"):
            root = tmp_path_factory.mktemp(f"chain_{pkg}")
            write_mmimdb(root)
            env = {"EXP_PATH": str(root)}
            two = ("--epochs", "2")
            assert run_cli_inproc(f"{pkg}.cli.train_monomodal", pretrain_yaml(root), run_id="1",
                                  cwd=root, env_extra=env, extra=two) == 0
            assert run_cli_inproc(f"{pkg}.cli.train_multimodal", CONFIG, run_id="1", cwd=root,
                                  env_extra=env, extra=two) == 0
            base = next((root / "experiments_output").glob("mm_imdb*"))
            artifact = root / "cmam.mmx"
            assert run_cli_inproc(f"{pkg}.cli.train_cmam", cmam_yaml(root, base), run_id="1",
                                  cwd=root, env_extra=env,
                                  extra=(*two, "--export-serving", str(artifact))) == 0
            out[pkg] = {"root": root, "base": base, "artifact": artifact}
    finally:
        mp.undo()
    out.update(reports=reports, loaded=loaded)
    yield out
    for pkg in ("mmtpu", "mmtpu_torch"):
        shutil.rmtree(out[pkg]["root"], ignore_errors=True)


def _files(root: Path):
    """Files by name, the checkpoint suffix and the TensorBoard file's stamp
    erased."""
    return sorted(re.sub(r"tfevents\..*", "tfevents",
                         p.relative_to(root).as_posix().replace(".pth", "·").replace(".ckpt", "·"))
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


def test_chain_writes_mmtpus_files(chain):
    ours, theirs = (_files(chain[p]["root"] / "experiments_output")
                    for p in ("mmtpu_torch", "mmtpu"))
    assert ours == theirs
    assert f"{PRETRAIN}/models/1/encoder_text_best·" in ours
    assert any(f.endswith("models/1/best·") and f.startswith("mm_imdb") for f in ours)
    assert f"{CMAM}/metrics/1/test_metrics.json" in ours


def _metrics_files(chain):
    root = chain["mmtpu"]["root"] / "experiments_output"
    return sorted(p.relative_to(root).as_posix() for p in root.rglob("metrics/1/*.json"))


@pytest.mark.parametrize("stage", [PRETRAIN, "mm_imdb", CMAM])
def test_records_match_mmtpu(chain, stage):
    """Every value of every metrics JSON of the stage at 1e-4."""
    names = [n for n in _metrics_files(chain) if n.startswith(stage)]
    assert names
    for name in names:
        mine, theirs = (json.loads((chain[p]["root"] / "experiments_output" / name).read_text())
                        for p in ("mmtpu_torch", "mmtpu"))
        a, b = list(_values(mine)), list(_values(theirs))
        assert [p for p, _ in a] == [p for p, _ in b], name
        for (path, x), (_, y) in zip(a, b):
            if "/timing/" in path or path.endswith(("_time", "/time")):
                continue
            if isinstance(y, float):
                assert abs(x - y) <= VALUE_TOL * max(abs(y), 1.0), (name, path, x, y)
            else:
                assert x == y, (name, path, x, y)


def test_encoder_optimizer_groups_reach_both_optimizers(chain):
    """The fine-tune's groups: lr 1e-6 on the two encoders, the default 1e-5
    on the rest, weight decay 1e-3 on all, in both packages' reports; in the
    port's optimizer, each parameter in the group of its module."""
    theirs, ours = chain["reports"]["mmtpu"][1][0], chain["reports"]["mmtpu_torch"][1][0]
    assert ours == theirs
    assert {kw["lr"] for kw in ours.values()} == {1e-6, 1e-5}
    optimizer = chain["reports"]["mmtpu_torch"][1][1]
    lrs = {}
    for group in optimizer.param_groups:
        for p in group["params"]:
            lrs[id(p)] = group["lr"]
    assert sorted(set(lrs.values())) == [1e-6, 1e-5]
    from mmtpu_torch.models import MMIMDbModalityEncoder

    per_encoder = len(list(MMIMDbModalityEncoder(300, 512).parameters()))
    assert sum(v == 1e-6 for v in lrs.values()) == 2 * per_encoder


def test_fine_tune_loads_the_text_encoder_bit_for_bit(chain):
    want = torch.load(chain["mmtpu_torch"]["root"] / HANDOFF, weights_only=True)
    assert set(chain["loaded"]) == set(want)
    for k, v in want.items():
        assert torch.equal(chain["loaded"][k], v), k


@pytest.mark.parametrize("split", ["train", "validation", "test"])
def test_cmam_record_keys_equal_the_reference_golden(chain, split):
    """The reference's C-MAM over MM-IMDb keys: the top level and the
    nested `classification` and `reconstruction` groups."""
    gold = json.loads((GOLDEN / f"{split}_metrics.json").read_text())
    path = chain["mmtpu_torch"]["root"] / "experiments_output" / CMAM / "metrics/1"
    ours = json.loads((path / f"{split}_metrics.json").read_text())
    assert set(ours[0]) == set(gold[0])
    for group in ("classification", "reconstruction"):
        assert set(ours[0][group]) == set(gold[0][group]), group
    assert all(0.0 <= r["classification"]["f1_micro_IT"] <= 1.0 for r in ours)


def test_cmam_artifact_answers_at_an_unseen_batch_size(chain):
    """task_type `cmam`, the image in, the text imputed; logits, multilabel
    predictions (sigmoid > 0.5) and the imputed embedding for 3 rows (the
    export traced another batch size)."""
    from mmtpu_torch.serving import load_artifact

    served = load_artifact(chain["mmtpu_torch"]["artifact"], "cpu")
    meta = served.meta
    assert (meta["task_type"], meta["imputes"], meta["input_keys"]) == ("cmam", ["text"],
                                                                       ["image"])
    out = served(image=np.random.default_rng(0).normal(size=(3, 4096)).astype(np.float32))
    assert out["logits"].shape == (3, 23) and out["rec_embd"].shape == (3, 512)
    assert np.isfinite(out["logits"]).all()
    np.testing.assert_array_equal(out["preds"], (1 / (1 + np.exp(-out["logits"])) > 0.5))
