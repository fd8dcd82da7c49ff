"""The port's serving export (mmtpu_torch.serving.export, ops/library.py)
against mmtpu's, on the CPU, at tiny widths, from mmtpu's weights carried by
`from_jax_variables` and inputs made from a seed with numpy:

- for AVMNIST, UttFusion, MM-IMDb, Kinetics-Sounds, a CMAM (AVMNIST base)
  and a DualCMAM (UttFusion base): the port's artifact, exported at B=4 and
  read back with `load_artifact(..., "cpu")`, answers at B=1 and B=7 within
  1e-5 of the port's in-process forward (`Predictor`, or the C-MAM serving
  function called eagerly) and of mmtpu's artifact (`export_task` /
  `export_cmam` with platforms ("cpu",), read back by mmtpu's
  `load_artifact`);
- its graph holds the kernels' operators: one `mmtpu.fused_mlp` (AVMNIST's
  eval head), one `mmtpu.lstm` (UttFusion's two encoders in one call), two
  (DualCMAM: its LSTM encoder and the base's audio encoder), none elsewhere;
- its meta has mmtpu's keys and values, with `torch_version` and `device`
  in place of `jax_version` and `platforms` and its own `format`;
- mmtpu's artifact file is refused with a `ValueError` that names it;
- `torch.library.opcheck` passes for both operators on CPU inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmtpu.models.registry import build_module as jax_build
from mmtpu.serving import export as jax_export
from mmtpu.train import cmam_loss as jax_cl
from mmtpu.train import cmam_step as jax_cs
from mmtpu.train.step import ClassificationTask as JaxTask
from mmtpu_torch.models import build_module
from mmtpu_torch.serving import (
    Predictor,
    export_cmam,
    export_task,
    load_artifact,
    make_cmam_serving_fn,
)
from mmtpu_torch.train import cmam_loss as cl
from mmtpu_torch.train import cmam_step as cs
from mmtpu_torch.train.step import ClassificationTask
from test_torch_port_cmam import _avmnist, _carry, _dual, _mnist, _perturb, _utt_base

CPU = torch.device("cpu")
TOL = 1e-5
RNG = jax.random.PRNGKey(0)
EXPORT_B = 4


def _ks(build, dropout=None):
    """Kinetics-Sounds at narrow widths; `dropout` sets all four rates."""
    audio_drop, video_drop, fusion_drop = (
        ({}, {}, {}) if dropout is None else
        ({"dropout_one": dropout, "dropout_two": dropout}, {"dropout": dropout},
         {"dropout": dropout}))

    def block(i, o):
        return build("conv_block", conv_block_one_args={"conv_one_in": i, "conv_one_out": o},
                     conv_block_two_args={"conv_one_in": o, "conv_one_out": o})

    audio = build("kinetics_sounds_audio_encoder", conv_block_one=block(1, 3),
                  conv_block_two=block(3, 4), conv_block_three=block(4, 6),
                  fc_one_input_size=16, fc_one_output_size=10, fc_two_output_size=8,
                  **audio_drop)
    video = build("kinetics_sounds_video_encoder", hidden_dim_one=12, hidden_dim_two=6,
                  **video_drop)
    return build("kineticssounds", audio_encoder=audio, video_encoder=video,
                 hidden_dim_one=14, hidden_dim_two=9, **fusion_drop)


def _mmimdb(build):
    return build("mmimdb",
                 image_encoder=build("mmimdb_modality_encoder", input_dim=40, output_dim=12),
                 text_encoder=build("mmimdb_modality_encoder", input_dim=9, output_dim=12),
                 classifier=build("mlp_genre_classifier", input_size=12, hidden_size=10,
                                  output_size=23),
                 gated_bimodal_network=build("gated_bimodal", input_one_dim=12,
                                             input_two_dim=12, output_one_dim=12,
                                             output_two_dim=12))


def _utt(build):  # equal hidden sizes: both recurrences in one call
    return build("utt_fusion",
                 netA=build("lstmencoder", input_size=5, hidden_size=8, embd_method="last"),
                 netV=build("lstmencoder", input_size=20, hidden_size=8, embd_method="last"),
                 netT=build("textcnn", input_size=16, embd_size=9, out_channels=4),
                 netC=build("fcclassifier", input_dim=25, layers=[16], output_dim=3,
                            dropout=0.0))


# family → (model factory, {input key: per-sample shape}, multilabel, expected op nodes)
FAMILIES = {
    "avmnist": (_avmnist, {"audio": (32, 94), "image": (28, 28, 1)}, False,
                {"fused_mlp": 1, "lstm": 0}),
    "utt_fusion": (_utt, {"audio": (6, 5), "video": (6, 20), "text": (6, 16)}, False,
                   {"fused_mlp": 0, "lstm": 1}),
    "mmimdb": (_mmimdb, {"image": (40,), "text": (9,)}, True, {"fused_mlp": 0, "lstm": 0}),
    "kinetics_sounds": (_ks, {"audio": (64, 64), "video": (400,)}, False,
                        {"fused_mlp": 0, "lstm": 0}),
}
CMAM_KINDS = {
    "cmam": ({"audio": (32, 94)}, {"fused_mlp": 0, "lstm": 0}),
    "dual": ({"audio": (6, 5)}, {"fused_mlp": 0, "lstm": 2}),
}


def _inputs(shapes, n, seed):
    g = np.random.default_rng(seed)
    return {k: g.normal(size=(n, *s)).astype(np.float32) for k, s in shapes.items()}


def _classification(family, root):
    build, shapes, multilabel, ops = FAMILIES[family]
    jm, pm = build(jax_build), build(build_module)
    example = _inputs(shapes, EXPORT_B, 1)
    v = _perturb(dict(jm.init({"params": RNG}, *map(jnp.asarray, example.values()))), 2)
    _carry(v, pm).eval()
    keys = list(shapes)
    jtask = JaxTask(model=jm, loss_group=None, input_keys=keys, multilabel=multilabel)
    ptask = ClassificationTask(model=pm, loss_group=None, input_keys=keys,
                               multilabel=multilabel)
    jax_path = jax_export.export_task(jtask, v, example, root / "mmtpu.mmx", platforms=("cpu",))
    path = export_task(ptask, example, root / "port.mmx")
    predictor = Predictor(ptask, CPU)
    return {"path": path, "jax_path": jax_path, "shapes": shapes, "ops": ops,
            "reference": lambda **ins: predictor(**ins)}


def _cmam(kind, root):
    shapes, ops = CMAM_KINDS[kind]
    if kind == "cmam":
        base_j, base_p = _avmnist(jax_build), _avmnist(build_module)
        base_in = (jnp.zeros((2, 32, 94)), jnp.zeros((2, 28, 28, 1)))
        assoc = {"input_size": 6, "hidden_size": 10, "output_size": 8, "batch_norm": True}
        cm_j, cm_p = (build("cmam", input_encoders={"audio": _mnist(build, "audio", 6)},
                            association_network=dict(assoc), target_modality="image")
                      for build in (jax_build, build_module))
        cm_in = {"audio": jnp.zeros((2, 32, 94))}
        extra = {"input_modalities": ["audio"], "target_modality": "image",
                 "base_model_type": "avmnist"}
        classes = (jax_cs.CMAMTask, cs.CMAMTask)
    else:
        base_j, base_p = _utt_base(jax_build), _utt_base(build_module)
        base_in = (jnp.zeros((2, 6, 5)), jnp.zeros((2, 6, 20)), jnp.zeros((2, 6, 16)))
        cm_j, cm_p = _dual(jax_build), _dual(build_module)
        cm_in = jnp.zeros((2, 6, 5))
        extra = {"input_modalities": ["audio"], "target_modality": "video",
                 "target_modality_two": "text", "base_model_type": "utt-fusion"}
        classes = (jax_cs.DualCMAMTask, cs.DualCMAMTask)
    base_v = _perturb(dict(base_j.init({"params": RNG}, *base_in)), 3)
    cm_v = _perturb(dict(cm_j.init({"params": RNG}, cm_in)), 4)
    _carry(base_v, base_p)
    _carry(cm_v, cm_p).eval()
    jtask = classes[0](cmam_model=cm_j, base_model=base_j, base_variables=base_v,
                       loss=jax_cl.CMAMLoss(), **extra)
    ptask = classes[1](cmam_model=cm_p, base_model=base_p, loss=cl.CMAMLoss(), **extra)
    example = _inputs(shapes, EXPORT_B, 1)
    jax_path = jax_export.export_cmam(jtask, cm_v, example, root / "mmtpu.mmx",
                                      platforms=("cpu",))
    path = export_cmam(ptask, example, root / "port.mmx")
    eager = make_cmam_serving_fn(ptask)

    def reference(**ins):
        with torch.no_grad():
            out = eager(*(torch.from_numpy(ins[k]) for k in ptask.input_modalities))
        return {k: v.numpy() for k, v in out.items()}

    return {"path": path, "jax_path": jax_path, "shapes": shapes, "ops": ops,
            "reference": reference}


@pytest.fixture(scope="module", params=[*FAMILIES, *CMAM_KINDS])
def exported(request, tmp_path_factory):
    root = tmp_path_factory.mktemp(request.param)
    build = _cmam if request.param in CMAM_KINDS else _classification
    art = build(request.param, root)
    art["served"] = load_artifact(art["path"], "cpu")
    art["jax_served"] = jax_export.load_artifact(art["jax_path"])
    return art


@pytest.mark.parametrize("batch", [1, 7])
def test_artifact_matches_the_forward_and_mmtpus_artifact(exported, batch):
    ins = _inputs(exported["shapes"], batch, 10 + batch)
    got = exported["served"](**ins)
    want = exported["reference"](**ins)
    jax_want = exported["jax_served"](**ins)
    assert set(got) == set(want) == set(jax_want)
    for k in got:
        assert got[k].shape[0] == batch
        np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL, err_msg=k)
        np.testing.assert_allclose(got[k], jax_want[k], rtol=TOL, atol=TOL, err_msg=k)


def test_graph_holds_the_kernels_operators(exported):
    targets = [str(n.target) for n in exported["served"].program.graph.nodes
               if n.op == "call_function"]
    found = {name: sum(t.startswith(f"mmtpu.{name}") for t in targets)
             for name in ("fused_mlp", "lstm")}
    assert found == exported["ops"]


def test_meta_has_mmtpus_keys_and_values(exported):
    ours, theirs = dict(exported["served"].meta), dict(exported["jax_served"].meta)
    assert ours.pop("format") == "mmtpu-torch-serve-1"
    assert theirs.pop("format") == "mmtpu-serve-1"
    assert ours.pop("torch_version") == torch.__version__ and ours.pop("device") == "cpu"
    assert theirs.pop("jax_version") and theirs.pop("platforms") == ["cpu"]
    assert ours == theirs
    assert ours["input_shapes"][0][0] == "b" and ours["symbolic_batch"] is True


def test_mmtpus_artifact_is_refused_by_name(exported):
    with pytest.raises(ValueError, match="mmtpu's StableHLO serving artifact"):
        load_artifact(exported["jax_path"], "cpu")


def test_other_files_are_refused(tmp_path):
    path = tmp_path / "x.mmx"
    path.write_bytes(b"not an artifact")
    with pytest.raises(ValueError, match="not an mmtpu_torch serving artifact"):
        load_artifact(path, "cpu")


@pytest.mark.parametrize("family", ["avmnist", "utt_fusion"])
def test_export_leaves_the_callers_task_as_it_was(family, tmp_path):
    """The trace runs on a copy: the caller's model keeps its mode, its
    weights and their storage."""
    build, shapes, multilabel, _ = FAMILIES[family]
    model = build(build_module).train()
    task = ClassificationTask(model=model, loss_group=None, input_keys=list(shapes),
                              multilabel=multilabel)
    before = {k: (v.clone(), v.data_ptr()) for k, v in model.state_dict().items()}
    export_task(task, _inputs(shapes, EXPORT_B, 1), tmp_path / "port.mmx")
    assert all(m.training for m in model.modules())
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k][0]) and v.data_ptr() == before[k][1], k


def test_the_card_is_the_default_device(exported, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_artifact(exported["path"])


def _opcheck_cases():
    g = torch.Generator().manual_seed(0)
    mlp = (torch.randn(5, 7, generator=g), [torch.randn(6, 7, generator=g),
                                             torch.randn(3, 6, generator=g)],
           [torch.randn(6, generator=g), torch.randn(3, generator=g)])
    xw = [torch.randn(3, 4, 8, generator=g) for _ in range(2)]
    wh = [torch.randn(2, 8, generator=g) for _ in range(2)]
    state = torch.randn(2, 2, 3, 2, generator=g)
    lengths = torch.tensor([[0, 2, 4], [4, 1, 3]], dtype=torch.int32)
    return [("fused_mlp", mlp), ("lstm", (xw, wh, None, None, None)),
            ("lstm", (xw, wh, state[0], state[1], lengths))]


@pytest.mark.parametrize("name,args", _opcheck_cases(), ids=["fused_mlp", "lstm", "lstm_state"])
def test_opcheck(name, args):
    torch.library.opcheck(getattr(torch.ops.mmtpu, name).default, args)


# -- the CLIs: predict --export, then serve --artifact ------------------------------

def _post(url, payload):
    import json
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(payload).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_predict_exports_and_serve_answers_from_the_artifact(tmp_path):
    """`predict --export` on a tiny AVMNIST run writes an artifact whose meta
    names the config and checkpoint; `serve --artifact` answers /predict
    within 1e-5 of the run's Predictor, /meta is the artifact's, a
    mis-shaped request gets 400; --artifact and --config exclude each
    other."""
    import json
    import urllib.error
    import urllib.request

    from mmtpu_torch.checkpoints import save_pth
    from mmtpu_torch.cli import common, predict, serve
    from mmtpu_torch.config import StandardMultimodalConfig
    from mmtpu_torch.models import seeded_init
    from test_torch_port_serving import TINY_YAML

    cfg_path = tmp_path / "tiny.yaml"
    cfg_path.write_text(TINY_YAML.replace("ROOT", str(tmp_path / "out")))
    cfg = StandardMultimodalConfig.load(cfg_path, run_id=1)
    save_pth(seeded_init(common.build_model_from_config(cfg.model), 5),
             common.checkpoint_path(cfg, "best"))
    art = tmp_path / "avmnist.mmx"
    assert predict.main(["--config", str(cfg_path), "--run_id", "1", "--cpu",
                         "--out", str(tmp_path / "preds.json"), "--export", str(art)]) == 0

    served, meta = serve.load_model(serve.arg_parser().parse_args(
        ["--artifact", str(art), "--cpu"]))
    assert meta == served.meta and served.device == CPU
    assert meta["config"] == str(cfg_path) and meta["checkpoint"] == "best"
    assert meta["input_shapes"] == [["b", 32, 94], ["b", 28, 28, 1]]
    args = predict.arg_parser().parse_args(["--config", str(cfg_path), "--cpu"])
    task, _ = predict.build_task_and_loader(cfg, args, CPU)
    ins = _inputs({"audio": (32, 94), "image": (28, 28, 1)}, 5, 9)
    ins["image"][1] = 0.0  # the image missing
    direct = Predictor(task, CPU)(**ins)
    with serve.ServerThread(served, meta) as st:
        with urllib.request.urlopen(f"{st.url}/meta", timeout=60) as r:
            assert json.loads(r.read()) == json.loads(json.dumps(meta))
        for i in range(5):
            ans = _post(f"{st.url}/predict", {k: v[i].tolist() for k, v in ins.items()})
            np.testing.assert_allclose(ans["logits"], direct["logits"][i], rtol=TOL, atol=TOL)
            assert ans["preds"] == int(direct["preds"][i])
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{st.url}/predict", {"audio": ins["audio"][0, :16].tolist(),
                                        "image": ins["image"][0].tolist()})
        assert e.value.code == 400
    assert serve.main(["--artifact", str(art), "--cpu", "--dry-run", "--port", "0"]) == 0
    with pytest.raises(SystemExit):
        serve.arg_parser().parse_args(["--artifact", str(art), "--config", str(cfg_path)])
