"""The port's serving slice as a whole, against mmtpu, on a small synthetic
split: config loading, loader batches, eval logits, the predict CLI's JSON,
the HTTP endpoints, and the entry points' device rule.

One tiny run is shared by the tests: a config with small ResNet encoders,
mmtpu variables from a seed (BatchNorm statistics perturbed), written as
mmtpu's `best.ckpt` and, through `from_jax_variables`, as the port's
`best.pth` in the same model directory."""

import json
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

REPO = Path(__file__).resolve().parent.parent
SYNTH_YAML = REPO / "configs/avmnist/synthetic_multimodal_pretrained.yaml"
TOL = 1e-4  # fp32 convolutions sum in different orders in XLA and PyTorch

TINY_YAML = """!StandardConfig
experiment: !ExperimentConfig
  name: "Tiny_AVMNIST_Port"
  seed: 7
  device: "tpu"
model: !ModelConfig
  name: "Tiny_AVMNIST_Port"
  model_type: "AVMNIST"
  audio_encoder: !ResNetEncoder
    layers: [1, 1, 1, 1]
    in_channels: 1
    hidden_dim: 16
  image_encoder: !ResNetEncoder
    layers: [1, 1, 1, 1]
    in_channels: 1
    hidden_dim: 24
  hidden_dim: 32
  dropout: 0.5
  fusion_fn: "concat"
training:
  epochs: 1
  num_modalities: 2
  optimizer: !Optimizer
    name: "Adam"
    default_kwargs: {lr: 0.001}
  loss_functions: !LossFunctionGroup
    cross_entropy: {loss_name: "cross_entropy", loss_args: {}, weight: 1.0}
data: !DataConfig
  datasets:
    train: !DatasetConfig
      dataset: "synthetic_avmnist"
      data_fp: "unused"
      split: "train"
      target_modality: !Modality "MULTIMODAL"
      batch_size: 16
      shuffle: true
      kwargs: {num_samples: 24}
      missing_patterns: !MissingPatternConfig
        modalities:
          !Modality audio: !ModalityConfig {missing_rate: 0.3}
          !Modality image: !ModalityConfig {missing_rate: 0.0}
        selected_patterns: ["ai", "a", "i"]
    test: !DatasetConfig
      dataset: "synthetic_avmnist"
      data_fp: "unused"
      split: "test"
      target_modality: !Modality "MULTIMODAL"
      batch_size: 16
      kwargs: {num_samples: 20}
      missing_patterns: !MissingPatternConfig
        modalities:
          !Modality audio: !ModalityConfig {missing_rate: 0.3}
          !Modality image: !ModalityConfig {missing_rate: 0.0}
        selected_patterns: ["ai", "a", "i"]
metrics:
  metrics: {}
logging:
  log_path: "ROOT/{experiment_name}/logs/{run_id}"
  model_output_path: "ROOT/{experiment_name}/models/{run_id}"
  metrics_path: "ROOT/{experiment_name}/metrics/{run_id}"
  save_metric: "loss"
monitoring:
  enabled: false
"""


def _perturb(variables, seed):
    g = np.random.default_rng(seed)
    out = {}
    for col, tree in variables.items():
        flat = flatten_dict(jax.tree_util.tree_map(np.asarray, tree))
        for path, v in flat.items():
            if path[-1] == "scale":
                v = (1.0 + 0.1 * g.normal(size=v.shape)).astype(np.float32)
            elif path[-1] in ("bias", "mean"):
                v = (0.1 * g.normal(size=v.shape)).astype(np.float32)
            elif path[-1] == "var":
                v = g.uniform(0.5, 1.5, size=v.shape).astype(np.float32)
            flat[path] = v
        out[col] = unflatten_dict(flat)
    return out


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """(config path, mmtpu cfg, mmtpu task, variables, port cfg, port task)."""
    from mmtpu.checkpoints.manager import CheckpointManager
    from mmtpu.cli import common as jcommon
    from mmtpu.config import StandardMultimodalConfig as JaxConfig
    from mmtpu.modalities import Modality as JaxModality
    from mmtpu.train.step import ClassificationTask as JaxTask
    from mmtpu_torch.checkpoints import from_jax_variables
    from mmtpu_torch.cli import common
    from mmtpu_torch.config import StandardMultimodalConfig
    from mmtpu_torch.train.step import ClassificationTask

    root = tmp_path_factory.mktemp("tiny_run")
    cfg_path = root / "tiny.yaml"
    cfg_path.write_text(TINY_YAML.replace("ROOT", str(root / "out")))

    jcfg = JaxConfig.load(cfg_path, run_id=1)
    jmodel = jcommon.build_model_from_config(jcfg.model)
    ds = jcfg.data.datasets["test"].build_dataset(seed=jcfg.experiment.seed)
    params, stats = jcommon.init_model(
        jmodel, jcommon.sample_inputs_for(ds, [JaxModality.AUDIO, JaxModality.IMAGE]), 0
    )
    v = _perturb({"params": params, "batch_stats": stats}, 11)
    state = jcommon.make_state(jmodel, v["params"], v["batch_stats"], jcfg.training)
    mgr = CheckpointManager(jcfg.logging.model_output_path)
    mgr.save_checkpoint(state, epoch=1, metric_value=0.5)
    mgr.wait()
    jtask = JaxTask(model=jmodel, loss_group=jcfg.training.loss_functions,
                    input_keys=["audio", "image"])

    pcfg = StandardMultimodalConfig.load(cfg_path, run_id=1)
    pmodel = common.build_model_from_config(pcfg.model)
    pmodel.load_state_dict(
        from_jax_variables(v["params"], v["batch_stats"], target=pmodel), strict=True
    )
    torch.save(pmodel.state_dict(), common.checkpoint_path(pcfg, "best"))
    ptask = ClassificationTask(model=pmodel.eval(),
                               loss_group=pcfg.training.loss_functions,
                               input_keys=["audio", "image"])
    return cfg_path, jcfg, jtask, v, pcfg, ptask


@pytest.mark.parametrize("split", ["train", "test"])
def test_loader_batches_are_byte_identical(tiny_run, split):
    _, jcfg, _, _, pcfg, _ = tiny_run
    seed = jcfg.experiment.seed
    jl = jcfg.data.build_loader(split, seed=seed)
    pl = pcfg.data.build_loader(split, seed=seed)
    assert pl.pattern_vocab == jl.pattern_vocab
    for epoch in range(2):  # the train split reshuffles and redraws patterns
        jb, pb = list(jl), list(pl)
        assert len(jb) == len(pb) == len(jl), f"epoch {epoch}"
        for a, b in zip(jb, pb):
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
                assert a[k].tobytes() == b[k].tobytes(), f"{split} {k}"
    # the masks really drop modalities: some audio rows are zeroed in "ai"
    keep = np.concatenate([b["audio_mask"] for b in pb])
    assert 0 < keep.sum() < len(keep)


def test_eval_logits_match_mmtpu_task_for_every_batch(tiny_run):
    from mmtpu_torch.train.step import make_eval_step

    _, jcfg, jtask, v, pcfg, ptask = tiny_run
    step = make_eval_step(ptask, torch.device("cpu"))
    loader = pcfg.data.build_loader("test", seed=pcfg.experiment.seed)
    n = 0
    for batch in loader:
        out = step(batch)
        want = np.asarray(jtask.apply(v, batch, train=False))
        np.testing.assert_allclose(out["logits"].numpy(), want, rtol=TOL, atol=TOL)
        jloss = float(jtask.loss(want, batch, sample_mask=batch["sample_mask"]))
        assert abs(out["loss"].item() - jloss) < TOL
        n += 1
    assert n == len(loader) == 4  # 60 visits in batches of 16, the last padded


def _run_predict(module, cfg_path, out, cwd, extra=()):
    from _cli_harness import run_cli_inproc

    code = run_cli_inproc(module, cfg_path, run_id="1", cwd=cwd,
                          extra=["--out", str(out), *extra])
    assert code == 0
    return json.loads(Path(out).read_text())


def test_predict_cli_json_matches_mmtpu(tiny_run, tmp_path):
    from mmtpu_torch.train.step import make_eval_step

    cfg_path, _, _, _, pcfg, ptask = tiny_run
    want = _run_predict("mmtpu.cli.predict", cfg_path, tmp_path / "jax.json", tmp_path)
    got = _run_predict("mmtpu_torch.cli.predict", cfg_path, tmp_path / "port.json", tmp_path)
    assert list(got) == list(want) == ["split", "checkpoint", "accuracy_per_pattern",
                                       "predictions"]
    assert got["split"] == want["split"] and got["checkpoint"] == want["checkpoint"]
    assert len(got["predictions"]) == len(want["predictions"]) == 60  # pads dropped
    assert got["accuracy_per_pattern"] == want["accuracy_per_pattern"]

    # predictions agree wherever the logit margin exceeds the tolerance
    step = make_eval_step(ptask, torch.device("cpu"))
    logits = torch.cat([
        step(b)["logits"][torch.from_numpy(b["sample_mask"] > 0)]
        for b in pcfg.data.build_loader("test", seed=pcfg.experiment.seed)
    ])
    top2 = logits.topk(2, dim=-1).values
    clear = ((top2[:, 0] - top2[:, 1]) > 2 * TOL).tolist()
    for c, g, w in zip(clear, got["predictions"], want["predictions"]):
        assert set(g) == set(w) == {"pattern", "pred", "label", "correct"}
        assert (g["pattern"], g["label"]) == (w["pattern"], w["label"])
        if c:
            assert g["pred"] == w["pred"]


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def test_http_endpoints(tiny_run):
    from mmtpu_torch.cli import serve

    cfg_path = tiny_run[0]
    args = serve.arg_parser().parse_args(["--config", str(cfg_path), "--cpu"])
    predictor, meta = serve.load_model(args)
    g = np.random.default_rng(3)
    audio = g.normal(size=(6, 32, 94)).astype(np.float32)
    image = g.normal(size=(6, 28, 28, 1)).astype(np.float32)
    image[0] = 0.0  # a sample with the image missing
    direct = predictor(audio=audio, image=image)
    with serve.ServerThread(predictor, meta, max_batch=4, max_wait_ms=20.0) as st:
        assert _get(f"{st.url}/health") == {"status": "ok", "model": "AVMNIST"}
        got_meta = _get(f"{st.url}/meta")
        assert got_meta["input_keys"] == ["audio", "image"]
        assert got_meta["input_shapes"] == [["b", 32, 94], ["b", 28, 28, 1]]
        with ThreadPoolExecutor(max_workers=6) as pool:
            rows = list(pool.map(
                lambda i: _post(f"{st.url}/predict", {"audio": audio[i].tolist(),
                                                      "image": image[i].tolist()}),
                range(6),
            ))
        batch = _post(f"{st.url}/predict_batch",
                      {"audio": audio.tolist(), "image": image.tolist()})
        stats = _get(f"{st.url}/stats")
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(f"{st.url}/predict", {"audio": audio[0].tolist()})
        err.value.close()
        assert err.value.code == 400
    assert stats["requests"] == 6 and stats["batches"] >= 2  # max_batch 4
    for i, row in enumerate(rows):
        np.testing.assert_allclose(row["logits"], direct["logits"][i], rtol=TOL, atol=TOL)
        assert row["preds"] == int(direct["preds"][i])
        np.testing.assert_allclose(sum(row["probs"]), 1.0, rtol=1e-5)
    np.testing.assert_allclose(batch["logits"], direct["logits"], rtol=TOL, atol=TOL)


def test_server_accept_queue_holds_a_burst_of_clients():
    """A burst of more concurrent clients than the listen backlog makes the
    kernel reset connections (socketserver's default backlog is 5)."""
    from mmtpu_torch.cli import serve

    def echo(x):
        return {"logits": np.asarray(x, np.float32)}

    meta = {"input_keys": ["x"], "input_shapes": [["b", 2]], "input_dtypes": ["float32"]}
    server, batcher = serve.make_server(echo, meta, port=0, max_batch=64, max_wait_ms=1.0)
    try:
        assert server.request_queue_size >= 64
    finally:
        server.server_close()
        batcher.close()
    with serve.ServerThread(echo, meta, max_batch=64, max_wait_ms=1.0) as st:
        with ThreadPoolExecutor(max_workers=48) as pool:
            rows = list(pool.map(
                lambda i: _post(f"{st.url}/predict", {"x": [float(i), 1.0]}), range(48)))
    assert [row["logits"] for row in rows] == [[float(i), 1.0] for i in range(48)]


def test_port_yaml_tags_leave_mmtpu_loading_alone(tiny_run):
    import yaml

    from mmtpu.config import StandardMultimodalConfig as JaxConfig
    from mmtpu.config.spec import ModuleSpec as JaxSpec
    from mmtpu.train.losses import LossFunctionGroup as JaxLoss
    from mmtpu_torch.config import ModuleSpec as PortSpec
    from mmtpu_torch.config import StandardMultimodalConfig
    from mmtpu_torch.train.losses import LossFunctionGroup as PortLoss

    for _ in range(2):  # any order of loading
        port = StandardMultimodalConfig.load(SYNTH_YAML, run_id=1)
        jax_cfg = JaxConfig.load(SYNTH_YAML, run_id=1)
        assert isinstance(port.model.kwargs["audio_encoder"], PortSpec)
        assert isinstance(port.training.loss_functions, PortLoss)
        assert isinstance(jax_cfg.model.kwargs["audio_encoder"], JaxSpec)
        assert isinstance(jax_cfg.training.loss_functions, JaxLoss)
    # the global SafeLoader still holds mmtpu's constructors only
    assert "!ResNet18" in yaml.SafeLoader.yaml_constructors
    ctor = yaml.SafeLoader.yaml_constructors["!ResNet18"]
    assert ctor.__module__ == "mmtpu.config.yaml_tags"


def _without_timestamp(d):
    d["logging"].pop("timestamp")
    return d


def test_chip_smoke_config_dict_matches_the_yaml(tmp_path):
    """chip_smoke.py builds its config from a dict (the card's machine has
    no PyYAML); at the YAML's sizes it is the YAML."""
    from chip_smoke import smoke_config
    from mmtpu_torch.config import StandardMultimodalConfig

    from_yaml = StandardMultimodalConfig.load(SYNTH_YAML, run_id=1).to_dict()
    raw = smoke_config(num_samples=96, batch_size=64)
    from_dict = StandardMultimodalConfig.from_parsed(raw, run_id=1).to_dict()
    assert _without_timestamp(from_dict) == _without_timestamp(dict(from_yaml))
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(raw))
    from_json = StandardMultimodalConfig.load(path, run_id=1).to_dict()
    assert _without_timestamp(from_json) == from_dict


def test_loss_group_refuses_what_is_not_ported():
    from mmtpu_torch.train.cmam_loss import CMAMLoss
    from mmtpu_torch.train.losses import LossFunctionGroup

    # the registry is ported in full, C-MAM's criterion included; a name no
    # package knows is refused
    with pytest.raises(ValueError, match="Unknown criterion"):
        LossFunctionGroup.from_dict({"t": {"loss_name": "no_such_loss"}})
    group = LossFunctionGroup.from_dict(
        {"cmam": {"loss_name": "cmam", "loss_kwargs": {"cls_weight": 0.0}}})
    assert isinstance(group["cmam"].loss_fn, CMAMLoss)


def test_entry_points_raise_without_cuda_unless_asked_for_cpu(tiny_run, monkeypatch):
    from mmtpu_torch.cli import common, predict, serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert common.resolve_device(cpu=True) == torch.device("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        common.resolve_device()
    cfg = str(tiny_run[0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        predict.main(["--config", cfg])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--config", cfg, "--dry-run"])
