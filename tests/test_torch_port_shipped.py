"""The shipped-weights AVMNIST flow in the port against mmtpu, on the CPU:

- the four `configs/avmnist/shipped_wheights_*.yaml` parse with the port's
  loader (`!MNISTAudio`, `!MNISTImage`, `!ConvBlockArgs`) and build the
  model mmtpu builds: the same parameters under mmtpu's paths, the same
  shapes (conv and Dense layouts carried), the same count; the `.pth`
  files they name are not opened;
- `shipped_wheights_finetune_audiofix.yaml`'s optimizer groups: the
  scratch audio encoder at the base learning rate 5e-4, the image encoder
  at 1e-4, in both packages;
- mmtpu's and the port's `train_multimodal` on a tiny twin of
  `shipped_wheights_finetune.yaml` (the file's model and optimizer; 2
  epochs; 40/16/16 samples in batches of 16 from `.pt` files the test
  writes; the image encoder from a reference-layout `.pth` the test writes,
  wrapped in `model_state_dict` with a `module.` prefix): the image encoder
  each package trains from holds the file's tensors exactly, and the two
  write the same files, directories and JSON keys. The two draw different
  initial weights for the rest, so metric values differ; checkpoints are
  compared by name (`.ckpt` in mmtpu, `.pth` in the port).
"""

import json
import re
import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from mmtpu_torch.checkpoints import from_jax_variables, mmtpu_param_path

REPO = Path(__file__).resolve().parent.parent
CONFIGS = REPO / "configs" / "avmnist"
SHIPPED = sorted(CONFIGS.glob("shipped_wheights_*.yaml"))

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _cli_harness import run_cli_inproc  # noqa: E402
from test_torch_port_checkpoints import reference_state  # noqa: E402
from _torch_threads import few_threads  # noqa: E402,F401 — in-process comparisons only


def _jax_config(path):
    from mmtpu.config import StandardMultimodalConfig as JaxConfig

    return JaxConfig.load(str(path), run_id=1)


def _port_config(path):
    from mmtpu_torch.config import StandardMultimodalConfig

    return StandardMultimodalConfig.load(str(path), run_id=1)


def test_four_shipped_configs_exist():
    assert [p.name for p in SHIPPED] == [
        "shipped_wheights_finetune.yaml", "shipped_wheights_finetune_audiofix.yaml",
        "shipped_wheights_finetune_fc.yaml", "shipped_wheights_scratch.yaml"]


@pytest.mark.parametrize("path", SHIPPED, ids=[p.stem for p in SHIPPED])
def test_shipped_config_builds_mmtpus_model(path):
    from mmtpu.cli import common as jax_common

    from mmtpu_torch.cli import common

    jcfg, pcfg = _jax_config(path), _port_config(path)
    assert pcfg.model.pretrained_encoders == jcfg.model.pretrained_encoders
    jm = jax_common.build_model_from_config(jcfg.model)
    shapes = jax.eval_shape(lambda a, i: jm.init(jax.random.PRNGKey(0), a, i, train=False),
                            jax.ShapeDtypeStruct((1, 32, 94), jnp.float32),
                            jax.ShapeDtypeStruct((1, 28, 28, 1), jnp.float32))
    want = {"/".join(k): tuple(v.shape) for k, v in flatten_dict(shapes["params"]).items()}
    pm = common.build_model_from_config(pcfg.model)
    got = {}
    for name, p in pm.named_parameters():
        shape = tuple(p.shape)
        if p.dim() == 4:
            shape = (shape[2], shape[3], shape[1], shape[0])  # OIHW → HWIO
        elif p.dim() == 2:
            shape = shape[::-1]  # (out, in) → (in, out)
        got[mmtpu_param_path(name, p)] = shape
    assert got == want
    assert sum(p.numel() for p in pm.parameters()) == sum(
        int(np.prod(s)) for s in want.values()) == 664202
    assert pm.audio_encoder.net[5].in_features == 4800
    assert pm.image_encoder.net[5].in_features == 3136


def test_audiofix_groups_give_the_scratch_audio_encoder_the_base_lr():
    from mmtpu.cli import common as jax_common

    from mmtpu_torch.cli import common

    path = CONFIGS / "shipped_wheights_finetune_audiofix.yaml"
    jcfg, pcfg = _jax_config(path), _port_config(path)
    pm = common.build_model_from_config(pcfg.model)
    groups = common.encoder_param_groups(pcfg.training, pm)
    state = common.make_state(pm, pcfg.training)
    lrs = {g["label"]: (g["lr"], g["weight_decay"]) for g in state.optimizer.param_groups}
    assert groups == [("^audio_encoder/", {"lr": 0.0005, "weight_decay": 0.0001}),
                      ("^image_encoder/", {"lr": 0.0001, "weight_decay": 0.0001})]
    assert lrs == {"group_0": (5e-4, 1e-4), "group_1": (1e-4, 1e-4), "default": (5e-4, 1e-4)}
    jm = jax_common.build_model_from_config(jcfg.model)
    params = jax.eval_shape(lambda a, i: jm.init(jax.random.PRNGKey(0), a, i, train=False),
                            jax.ShapeDtypeStruct((1, 32, 94), jnp.float32),
                            jax.ShapeDtypeStruct((1, 28, 28, 1), jnp.float32))["params"]
    assert jax_common.encoder_param_groups(jcfg.training, params) == groups


# -- both packages' train_multimodal on a tiny twin -----------------------------------

SAMPLES = {"train": 40, "validation": 16, "test": 16}


def _write_data(root: Path, seed: int = 0):
    """One float32 spectrogram and one uint8 image `.pt` per sample, and a
    CSV per split; returns the CSV paths."""
    g = np.random.default_rng(seed)
    csvs = {}
    for split, n in SAMPLES.items():
        d = root / split
        d.mkdir(parents=True)
        rows = []
        for i in range(n):
            label = int(g.integers(0, 10))
            sp, ip = d / f"spec_{i}.pt", d / f"img_{i}.pt"
            torch.save(torch.from_numpy((g.normal(size=(32, 94)) + 0.3 * label)
                                        .astype(np.float32)), sp)
            torch.save(np.clip(g.normal(20.0 * label + 30, 40, size=(28, 28)), 0, 255)
                       .astype(np.uint8), ip)
            rows.append(f"{sp},{ip},{label}")
        csvs[split] = root / f"{split}.csv"
        csvs[split].write_text("audio,image,label\n" + "\n".join(rows) + "\n")
    return csvs


def _twin(root: Path, csvs: dict, pth: Path) -> Path:
    text = (CONFIGS / "shipped_wheights_finetune.yaml").read_text()
    text = text.replace('"./experiments_output', f'"{root}/out')
    text = text.replace("epochs: 20", "epochs: 2")
    text = text.replace("batch_size: 128", "batch_size: 16")
    # the image encoder's file: the one the config names, replaced by the test's
    text = re.sub(r'(pretrained_encoders:\s+image: )"[^"]*"', rf'\g<1>"{pth}"', text)
    for split in SAMPLES:
        text = text.replace(f"./DATA/avmnist/{split}_subset.csv", str(csvs[split]))
    dst = root / "shipped_twin.yaml"
    dst.write_text(text)
    return dst


def _tree(root: Path):
    return sorted(p.relative_to(root).as_posix().replace(".ckpt", ".·").replace(".pth", ".·")
                  for p in (root / "out").rglob("*") if "/epoch_" not in p.as_posix())


def structure(obj):
    if isinstance(obj, dict):
        return {k: structure(v) for k, v in sorted(obj.items())}
    if isinstance(obj, list):
        return [structure(v) for v in obj]
    return "·"


def _json(root: Path):
    return {p.relative_to(root).as_posix(): json.loads(p.read_text())
            for p in sorted((root / "out").rglob("*.json")) if "/models/" not in p.as_posix()}


@pytest.fixture(scope="module")
def twins(tmp_path_factory):
    from mmtpu.cli import common as jax_common

    from mmtpu_torch.cli import common

    sd = reference_state(seed=1)
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        for pkg in ("mmtpu", "mmtpu_torch"):
            root = tmp_path_factory.mktemp(f"shipped_{pkg}")
            pth = root / "lenet_image_best.pth"
            torch.save({"model_state_dict": {f"module.{k}": v for k, v in sd.items()}}, pth)
            cfg = _twin(root, _write_data(root / "data"), pth)
            loaded = []
            if pkg == "mmtpu":
                real = jax_common.load_pretrained_encoders

                def spy(params, batch_stats, *args, real=real):
                    params, batch_stats, mods = real(params, batch_stats, *args)
                    loaded.append(from_jax_variables(
                        jax.tree_util.tree_map(np.asarray, params["image_encoder"]),
                        jax.tree_util.tree_map(np.asarray, batch_stats["image_encoder"])))
                    return params, batch_stats, mods

                mp.setattr(jax_common, "load_pretrained_encoders", spy)
            else:
                real = common.load_pretrained_encoders

                def spy(model, *args, real=real):
                    mods = real(model, *args)
                    loaded.append({k: v.clone() for k, v in
                                   model.image_encoder.state_dict().items()})
                    return mods

                mp.setattr(common, "load_pretrained_encoders", spy)
            rc = run_cli_inproc(f"{pkg}.cli.train_multimodal", cfg, run_id="1")
            mp.undo()
            out[pkg] = {"rc": rc, "root": root, "loaded": loaded}
    finally:
        mp.undo()
    yield sd, out
    for run in out.values():
        shutil.rmtree(run["root"], ignore_errors=True)


def test_twin_runs_in_both_packages(twins):
    _, out = twins
    assert out["mmtpu"]["rc"] == out["mmtpu_torch"]["rc"] == 0


@pytest.mark.parametrize("pkg", ["mmtpu", "mmtpu_torch"])
def test_twin_trains_from_the_files_image_encoder(twins, pkg):
    sd, out = twins
    (loaded,) = out[pkg]["loaded"]
    for k, v in sd.items():
        if k.endswith("num_batches_tracked"):
            continue  # flax keeps no counter
        assert torch.equal(loaded[k], v), (pkg, k)


def test_twin_writes_mmtpus_files_and_json_keys(twins):
    _, out = twins
    ours, theirs = out["mmtpu_torch"]["root"], out["mmtpu"]["root"]
    assert _tree(ours) == _tree(theirs)
    name = "out/AVMNIST_ShippedWheights_Finetune"
    assert f"{name}/metrics/1/test_metrics.json" in _tree(ours)
    assert f"{name}/models/1/best.·" in _tree(ours)
    oj, tj = _json(ours), _json(theirs)
    assert sorted(oj) == sorted(tj)
    for key, data in tj.items():
        assert structure(oj[key]) == structure(data), key
    (test,) = oj[f"{name}/metrics/1/test_metrics.json"]
    assert {"loss", "accuracy_AI", "accuracy_A", "accuracy_I"} <= set(test)


def test_port_predict_refuses_a_best_pth_that_does_not_fit(twins):
    """predict on the port twin's run, its best.pth missing one tensor of
    the model: an error, not predictions from a tensor left at its initial
    value."""
    _, out = twins
    root = out["mmtpu_torch"]["root"]
    (best,) = (root / "out").rglob("models/1/best.pth")
    saved = best.read_bytes()
    tree = torch.load(best, weights_only=True)
    tree["model"].pop("fc_out.bias")
    torch.save(tree, best)
    try:
        with pytest.raises(RuntimeError, match=r"Missing key.*fc_out\.bias"):
            run_cli_inproc("mmtpu_torch.cli.predict", root / "shipped_twin.yaml", run_id="1",
                           extra=("--out", str(root / "predictions.json")))
    finally:
        best.write_bytes(saved)


def test_port_predicts_from_mmtpus_best_ckpt(twins):
    """The port's predict on the mmtpu twin's run: `best` resolves to
    mmtpu's `best.ckpt`, and the predictions are mmtpu's own."""
    _, out = twins
    root = out["mmtpu"]["root"]
    cfg = root / "shipped_twin.yaml"
    preds = {}
    for pkg in ("mmtpu", "mmtpu_torch"):
        path = root / f"predictions_{pkg}.json"
        assert run_cli_inproc(f"{pkg}.cli.predict", cfg, run_id="1",
                              extra=("--out", str(path))) == 0
        preds[pkg] = json.loads(path.read_text())
    ours, theirs = preds["mmtpu_torch"], preds["mmtpu"]
    assert len(ours["predictions"]) == len(theirs["predictions"]) == 3 * SAMPLES["test"]
    assert ours["predictions"] == theirs["predictions"]
    assert ours["accuracy_per_pattern"] == theirs["accuracy_per_pattern"]
