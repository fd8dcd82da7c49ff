"""The port's MOSI UttFusion slice against mmtpu on the CPU: each module
from mmtpu's own initialised variables carried through `from_jax_variables`
(every target leaf filled), the model as a whole under all 7 missing
patterns, the synthetic dataset, the predict CLI's JSON and the HTTP server.

Inputs come from numpy seeds. mmtpu's LSTM runs through its XLA scan here
(how its own tests run it off the TPU); the port's through the plain PyTorch
scan, since the tensors lie on the CPU."""

import json
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from mmtpu_torch.checkpoints import from_jax_variables
from _torch_threads import few_threads  # noqa: E402,F401 — in-process comparisons only

REPO = Path(__file__).resolve().parent.parent
SYNTH_YAML = REPO / "configs/mosi/synthetic_utt_fusion.yaml"
TOL = 1e-4  # fp32; XLA and PyTorch sum the recurrence and the convolutions in different orders

TINY_YAML = """!StandardConfig
experiment: !ExperimentConfig
  name: "Tiny_MOSI_Port"
  seed: 5
  device: "tpu"
model: !ModelConfig
  name: "Tiny_MOSI_Port"
  model_type: "utt-fusion"
  netA: !LSTMEncoder {input_size: 5, hidden_size: 8, embd_method: "maxpool"}
  netV: !LSTMEncoder {input_size: 20, hidden_size: 8, embd_method: "maxpool"}
  netT: !TextCNN {input_size: 768, embd_size: 8, out_channels: 4, dropout: 0.5}
  netC: !FcClassifier {input_dim: 24, layers: [16, 8], output_dim: 3, dropout: 0.3}
training:
  epochs: 1
  num_modalities: 3
  optimizer: !Optimizer
    name: "Adam"
    default_kwargs: {lr: 0.001}
  loss_functions: !LossFunctionGroup
    cross_entropy: {loss_name: "cross_entropy", loss_args: {}, weight: 1.0}
data: !DataConfig
  datasets:
    test: !DatasetConfig
      dataset: "synthetic_mosi"
      data_fp: "unused"
      split: "test"
      target_modality: !Modality "MULTIMODAL"
      batch_size: 16
      kwargs: {num_samples: 10, seq_len: 12}
      missing_patterns: !MissingPatternConfig
        modalities:
          !Modality audio: !ModalityConfig {missing_rate: 0.0}
          !Modality video: !ModalityConfig {missing_rate: 0.0}
          !Modality text: !ModalityConfig {missing_rate: 0.0}
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


def _perturbed(variables, seed):
    """mmtpu's initialised variables as numpy, with biases, BatchNorm scales
    and running statistics moved off their 0 / 1 initial values."""
    g = np.random.default_rng(seed)
    out = {}
    for col, tree in variables.items():
        flat = flatten_dict(jax.tree_util.tree_map(np.array, dict(tree)))  # writable copies
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


def _carry(jmodule, pmodule, *sample, seed=0):
    """Initialise the mmtpu module, carry its variables into the port module
    (strict: every leaf mapped, every target tensor filled) → variables."""
    variables = jmodule.init(jax.random.PRNGKey(seed), *[jnp.asarray(x) for x in sample])
    v = _perturbed(variables, seed + 1)
    state = from_jax_variables(v["params"], v.get("batch_stats"), target=pmodule)
    pmodule.load_state_dict(state, strict=True)
    pmodule.eval()
    return v


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("with_len", [False, True], ids=["full", "lengths"])
@pytest.mark.parametrize("embd_method", ["last", "attention", "maxpool"])
def test_lstm_encoder_matches_mmtpu(embd_method, with_len):
    from mmtpu.models.lstm import LSTMEncoder as JaxLSTMEncoder
    from mmtpu_torch.models import LSTMEncoder

    g = np.random.default_rng(0)
    x = g.normal(size=(6, 9, 5)).astype(np.float32)
    lengths = g.integers(1, 10, size=6).astype(np.int32) if with_len else None
    jm = JaxLSTMEncoder(input_size=5, hidden_size=12, embd_method=embd_method)
    pm = LSTMEncoder(input_size=5, hidden_size=12, embd_method=embd_method)
    v = _carry(jm, pm, x)
    want = jm.apply(v, jnp.asarray(x), None if lengths is None else jnp.asarray(lengths))
    got = pm(torch.from_numpy(x), None if lengths is None else torch.from_numpy(lengths))
    assert got.shape == (6, 12) and pm.get_embedding_size() == 12
    _close(got, want)
    keys = set(pm.state_dict())
    assert {"wi.weight", "wi.bias", "wh"} <= keys
    assert ("attention_vector_weight" in keys) == (embd_method == "attention")


def test_lstm_encoder_refuses_what_is_not_ported():
    from mmtpu_torch.models import LSTMEncoder, LSTMEncoder2

    assert LSTMEncoder2 is LSTMEncoder
    with pytest.raises(ValueError, match="backend"):
        LSTMEncoder(5, 8, backend="cudnn")
    with pytest.raises(ValueError, match="embd_method"):
        LSTMEncoder(5, 8, embd_method="mean")


@pytest.mark.parametrize("with_len", [False, True], ids=["full", "lengths"])
@pytest.mark.parametrize("embd_method", ["last", "attention", "maxpool"])
def test_lstm_encoder_rnn_backend_matches_mmtpu(embd_method, with_len):
    """backend='rnn' (flax's per-gate OptimizedLSTMCell under mmtpu's
    checkpoint names) through from_jax_variables: outputs and input
    gradients. Lengths include 0 (flax's carry index -1 wraps to the last
    step) and lengths past T (clamped), where `last` pooling differs from
    the fused backend's freeze. Past T, JAX's gather clamps the index in the
    forward but its transpose drops the cotangent (an out-of-bounds scatter),
    so those rows get no gradient through the carry, in mmtpu and in the
    port; the gradients are compared on every row."""
    from mmtpu.models.lstm import LSTMEncoder as JaxLSTMEncoder
    from mmtpu_torch.models import LSTMEncoder

    g = np.random.default_rng(10)
    T = 6
    x = g.normal(size=(8, T, 5)).astype(np.float32)
    lengths = np.array([0, 1, 3, 6, 7, 9, 2, 5], np.int32) if with_len else None
    jm = JaxLSTMEncoder(input_size=5, hidden_size=8, embd_method=embd_method, backend="rnn")
    pm = LSTMEncoder(input_size=5, hidden_size=8, embd_method=embd_method, backend="rnn")
    v = _carry(jm, pm, x)
    assert {k for k in pm.state_dict() if k.startswith("OptimizedLSTMCell_0.")} == {
        f"OptimizedLSTMCell_0.{n}.{leaf}" for n in ("ii", "if", "ig", "io", "hi", "hf", "hg",
                                                     "ho")
        for leaf in (("weight", "bias") if n[0] == "h" else ("weight",))}
    jl = None if lengths is None else jnp.asarray(lengths)
    want, want_vjp = jax.vjp(lambda xx: jm.apply(v, xx, jl), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = pm(xt, None if lengths is None else torch.from_numpy(lengths))
    finite = np.isfinite(np.asarray(want))  # maxpool over no valid step is -inf in both
    np.testing.assert_array_equal(np.isfinite(got.detach().numpy()), finite)
    np.testing.assert_allclose(got.detach().numpy()[finite], np.asarray(want)[finite],
                               rtol=1e-5, atol=1e-5)
    if embd_method == "attention" and with_len:
        return  # softmax over no valid step is NaN in both; no gradient to compare
    cot = np.where(finite, g.normal(size=want.shape), 0.0).astype(np.float32)
    (want_gx,) = want_vjp(jnp.asarray(cot))
    (got_gx,) = torch.autograd.grad(got, xt, torch.from_numpy(cot))
    np.testing.assert_allclose(got_gx.numpy(), np.asarray(want_gx), rtol=1e-5, atol=1e-5)


def test_rnn_encoders_do_not_stack_and_utt_fusion_matches_mmtpu(monkeypatch):
    """Two rnn encoders take one recurrence each, as in mmtpu
    (`can_stack_pair` asks for the fused backend); logits as mmtpu's."""
    from mmtpu.models import build_module as jbuild
    from mmtpu_torch.models import build_module as pbuild
    from mmtpu_torch.models import can_stack_pair
    from mmtpu_torch.models import lstm as plstm

    def make(build):
        return build(
            "utt_fusion",
            netA=build("lstmencoder", input_size=5, hidden_size=8, backend="rnn"),
            netV=build("lstmencoder", input_size=20, hidden_size=8, backend="rnn"),
            netT=build("textcnn", input_size=40, embd_size=6, out_channels=5, dropout=0.5),
            netC=build("fcclassifier", input_dim=22, layers=[12], output_dim=3, dropout=0.5),
        )

    calls = []
    real = plstm.lstm_sequence
    monkeypatch.setattr(plstm, "lstm_sequence",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    g = np.random.default_rng(11)
    ins = [g.normal(size=(4, 6, w)).astype(np.float32) for w in (5, 20, 40)]
    jm, pm = make(jbuild), make(pbuild)
    v = _carry(jm, pm, *ins)
    assert not can_stack_pair(pm.netA, pm.netV, *[torch.from_numpy(x) for x in ins[:2]])
    _close(pm(*[torch.from_numpy(x) for x in ins]), jm.apply(v, *[jnp.asarray(x) for x in ins]))
    assert len(calls) == 2


def test_textcnn_matches_mmtpu():
    from mmtpu.models.textcnn import TextCNN as JaxTextCNN
    from mmtpu_torch.models import TextCNN

    x = np.random.default_rng(1).normal(size=(4, 11, 30)).astype(np.float32)
    kw = dict(input_size=30, embd_size=7, out_channels=6, kernel_heights=(3, 4, 5))
    jm, pm = JaxTextCNN(**kw), TextCNN(**kw)
    v = _carry(jm, pm, x)
    assert pm.conv2.weight.shape == (6, 1, 4, 30)
    _close(pm(torch.from_numpy(x)), jm.apply(v, jnp.asarray(x)))


@pytest.mark.parametrize("use_bn", [False, True], ids=["plain", "bn"])
def test_fc_classifier_and_encoder_match_mmtpu(use_bn):
    from mmtpu.models.fc import FcClassifier as JaxFcClassifier
    from mmtpu.models.fc import FcEncoder as JaxFcEncoder
    from mmtpu_torch.models import FcClassifier, FcEncoder

    g = np.random.default_rng(2)
    x = g.normal(size=(5, 10)).astype(np.float32)
    kw = dict(input_dim=10, layers=(8, 6), output_dim=3, use_bn=use_bn)
    jm, pm = JaxFcClassifier(**kw), FcClassifier(**kw)
    v = _carry(jm, pm, x)
    _close(pm(torch.from_numpy(x)), jm.apply(v, jnp.asarray(x)))

    kw = dict(input_dim=10, layers=(8, 6), use_bn=use_bn)
    jm, pm = JaxFcEncoder(**kw), FcEncoder(**kw)
    v = _carry(jm, pm, x)
    assert pm.get_embedding_size() == 6
    # wider input is truncated, narrower zero-padded, rank 3 flattened first
    for other in (g.normal(size=(5, 13)), g.normal(size=(5, 7)), g.normal(size=(5, 2, 4))):
        other = other.astype(np.float32)
        _close(pm(torch.from_numpy(other)), jm.apply(v, jnp.asarray(other)))


def test_small_heads_match_mmtpu():
    from mmtpu.models.fc import MaxPoolFc as JaxMaxPoolFc
    from mmtpu.models.fc import SimpleClassifier as JaxSimpleClassifier
    from mmtpu_torch.models import MaxPoolFc, SimpleClassifier

    g = np.random.default_rng(3)
    x = g.normal(size=(4, 9)).astype(np.float32)
    jm, pm = JaxSimpleClassifier(embd_size=9, output_dim=3, dropout=0.2), \
        SimpleClassifier(embd_size=9, output_dim=3, dropout=0.2)
    v = _carry(jm, pm, x)
    _close(pm(torch.from_numpy(x)), jm.apply(v, jnp.asarray(x)))
    seq = g.normal(size=(4, 6, 9)).astype(np.float32)
    jm, pm = JaxMaxPoolFc(hidden_size=9, num_class=4), MaxPoolFc(hidden_size=9, num_class=4)
    v = _carry(jm, pm, seq)
    _close(pm(torch.from_numpy(seq)), jm.apply(v, jnp.asarray(seq)))


def _utt_pair(hidden_a, hidden_v, embd_method="last"):
    from mmtpu.models import build_module as jbuild
    from mmtpu_torch.models import build_module as pbuild

    def make(build):
        return build(
            "utt_fusion",
            netA=build("lstmencoder", input_size=5, hidden_size=hidden_a, embd_method=embd_method),
            netV=build("lstmencoder", input_size=20, hidden_size=hidden_v, embd_method=embd_method),
            netT=build("textcnn", input_size=40, embd_size=6, out_channels=5, dropout=0.5),
            netC=build("fcclassifier", input_dim=hidden_a + hidden_v + 6, layers=[12, 8],
                       output_dim=3, dropout=0.5),
        )

    return make(jbuild), make(pbuild)


@pytest.mark.parametrize("hidden_a,hidden_v,route", [(8, 8, "stacked"), (8, 12, "separate")])
def test_utt_fusion_matches_mmtpu_on_both_routes(hidden_a, hidden_v, route, monkeypatch):
    """Equal hidden sizes → one stacked recurrence over both encoders;
    unequal → one call per encoder. Either way mmtpu's logits, also with an
    input zeroed."""
    from mmtpu_torch.models import lstm as plstm

    calls = []
    for name in ("lstm_sequence", "lstm_sequence_stacked"):
        real = getattr(plstm, name)
        monkeypatch.setattr(
            plstm, name,
            lambda *a, _real=real, _name=name, **k: calls.append(_name) or _real(*a, **k),
        )
    g = np.random.default_rng(4)
    A = g.normal(size=(6, 10, 5)).astype(np.float32)
    V = g.normal(size=(6, 10, 20)).astype(np.float32)
    T = g.normal(size=(6, 10, 40)).astype(np.float32)
    jm, pm = _utt_pair(hidden_a, hidden_v)
    v = _carry(jm, pm, A, V, T)
    for zeroed in (None, 0, 1, 2):
        ins = [A, V, T]
        if zeroed is not None:
            ins[zeroed] = np.zeros_like(ins[zeroed])
        calls.clear()
        got = pm(*[torch.from_numpy(x) for x in ins])
        assert calls == (["lstm_sequence_stacked"] if route == "stacked"
                         else ["lstm_sequence", "lstm_sequence"])
        _close(got, jm.apply(v, *[jnp.asarray(x) for x in ins]))
    # embeddings in place of inputs, and the encoders alone
    with torch.no_grad():
        ea, ev, et = pm.encode(*[torch.from_numpy(x) for x in (A, V, T)])
    ja, jv, jt = jm.apply(v, jnp.asarray(A), jnp.asarray(V), jnp.asarray(T), method="encode")
    for got, want in ((ea, ja), (ev, jv), (et, jt)):
        _close(got, want)
    got = pm(ea, torch.from_numpy(V), torch.from_numpy(T), is_embd_A=True)
    _close(got, jm.apply(v, ja, jnp.asarray(V), jnp.asarray(T), is_embd_A=True))


def test_from_jax_variables_still_raises_on_unknown_and_misshapen_leaves():
    from mmtpu_torch.models import LSTMEncoder

    pm = LSTMEncoder(5, 4, embd_method="attention")
    good = {
        "wi": {"kernel": np.zeros((5, 16), np.float32), "bias": np.zeros(16, np.float32)},
        "wh": np.zeros((4, 16), np.float32),
        "attention_layer": {"kernel": np.zeros((4, 4), np.float32),
                            "bias": np.zeros(4, np.float32)},
        "attention_vector_weight": np.zeros((4, 1), np.float32),
    }
    assert set(from_jax_variables(good, target=pm)) == set(pm.state_dict())
    with pytest.raises(ValueError, match="no torch counterpart"):
        from_jax_variables({**good, "hi": np.zeros(3, np.float32)}, target=pm)
    with pytest.raises(ValueError, match="rank"):
        from_jax_variables({**good, "wh": np.zeros(64, np.float32)}, target=pm)
    with pytest.raises(ValueError, match="target wants"):
        from_jax_variables({**good, "wh": np.zeros((16, 4), np.float32)}, target=pm)
    with pytest.raises(ValueError, match="unfilled"):
        from_jax_variables({k: v for k, v in good.items() if k != "wh"}, target=pm)


@pytest.mark.parametrize("kwargs", [
    {},
    {"num_samples": 9, "seq_len": 7, "seed": 3},
    {"labels_key": "regression_labels", "num_samples": 5, "seq_len": 4},
    {"text_mode": "bert", "num_samples": 6, "seq_len": 8, "num_classes": 2},
], ids=["default", "small", "regression", "bert"])
def test_synthetic_mosi_is_bit_identical(kwargs):
    from mmtpu.data.mosi import SyntheticMOSI as JaxSyntheticMOSI
    from mmtpu_torch.data import SyntheticMOSI, resolve_dataset_name
    from mmtpu_torch.data.mosi import DEFAULT_MSA_PATTERNS

    assert resolve_dataset_name("synthetic_mosi") is SyntheticMOSI
    jd, pd = JaxSyntheticMOSI(split="test", **kwargs), SyntheticMOSI(split="test", **kwargs)
    assert pd.labels.dtype == jd.labels.dtype and pd.labels.tobytes() == jd.labels.tobytes()
    assert [str(m) for m in pd.arrays] == [str(m) for m in jd.arrays] == ["audio", "video", "text"]
    for (jm, ja), (pm, pa) in zip(jd.arrays.items(), pd.arrays.items()):
        assert pa.shape == ja.shape and pa.tobytes() == ja.tobytes(), str(pm)
    assert pd.pattern_vocab() == jd.pattern_vocab() and len(pd) == len(jd)
    assert sorted(pd.pattern_vocab()) == sorted(DEFAULT_MSA_PATTERNS)
    for pattern in jd.masks:
        for jm, mask in jd.masks[pattern].items():
            assert pd.masks[pattern][str(jm)].tobytes() == mask.tobytes(), (pattern, str(jm))


def test_mosi_pickle_reader_and_lengths_ride_along(tmp_path):
    import pickle

    from mmtpu.data.loader import BatchLoader as JaxLoader
    from mmtpu.data.mosi import MOSI as JaxMOSI
    from mmtpu_torch.data import MOSEI, MOSI, BatchLoader, resolve_dataset_name

    assert resolve_dataset_name("MOSI") is MOSI and resolve_dataset_name("mosei") is MOSEI
    g = np.random.default_rng(5)
    split = {
        "audio": g.normal(size=(7, 6, 5)), "vision": g.normal(size=(7, 6, 20)),
        "text": g.normal(size=(7, 6, 16)), "classification_labels": g.integers(0, 3, 7),
        "audio_lengths": g.integers(1, 7, 7), "vision_lengths": g.integers(1, 7, 7),
    }
    fp = tmp_path / "mosi.pkl"
    fp.write_bytes(pickle.dumps({"test": split}))
    jl = JaxLoader(JaxMOSI(fp, "test", seed=1), batch_size=4)
    pl = BatchLoader(MOSI(fp, "test", seed=1), batch_size=4)
    n = 0
    for a, b in zip(jl, pl):
        assert sorted(a) == sorted(b) and "audio_lengths" in b and "text_lengths" not in b
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
        n += 1
    assert n == len(pl) == 13  # 7 samples × 7 patterns in batches of 4
    with pytest.raises(FileNotFoundError):
        MOSI(tmp_path / "none.pkl", "test")
    assert "audio_lengths" not in next(iter(BatchLoader(MOSI(fp, "test", aligned=True), 4)))


def test_port_loads_the_repo_mosi_yaml():
    from mmtpu_torch.cli import common
    from mmtpu_torch.config import StandardMultimodalConfig
    from mmtpu_torch.models import UttFusionModel

    cfg = StandardMultimodalConfig.load(SYNTH_YAML, run_id=1)
    model = common.build_model_from_config(cfg.model)
    assert isinstance(model, UttFusionModel) and model.clip == 0.5
    assert model.netA.embd_method == "maxpool" and model.netC.fc_out.out_features == 3
    for spelling in ("utt-fusion", "utt_fusion", "UttFusionModel"):
        assert [str(m) for m in common.modalities_for_model(spelling)] == \
            ["audio", "video", "text"]


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """(config path, mmtpu cfg, mmtpu task, variables, port cfg, port task):
    one tiny UttFusion run, saved as mmtpu's `best.ckpt` and, through
    `from_jax_variables`, as the port's `best.pth` beside it."""
    from mmtpu.checkpoints.manager import CheckpointManager
    from mmtpu.cli import common as jcommon
    from mmtpu.cli.train_multimodal import modalities_for_model
    from mmtpu.config import StandardMultimodalConfig as JaxConfig
    from mmtpu.train.step import ClassificationTask as JaxTask
    from mmtpu_torch.cli import common
    from mmtpu_torch.config import StandardMultimodalConfig
    from mmtpu_torch.train.step import ClassificationTask

    root = tmp_path_factory.mktemp("tiny_mosi")
    cfg_path = root / "tiny.yaml"
    cfg_path.write_text(TINY_YAML.replace("ROOT", str(root / "out")))
    keys = ["audio", "video", "text"]

    jcfg = JaxConfig.load(cfg_path, run_id=1)
    jmodel = jcommon.build_model_from_config(jcfg.model)
    ds = jcfg.data.datasets["test"].build_dataset(seed=jcfg.experiment.seed)
    mods = modalities_for_model(jcfg.model.model_type)
    assert [str(m) for m in mods] == keys
    params, stats = jcommon.init_model(jmodel, jcommon.sample_inputs_for(ds, mods), 0)
    v = _perturbed({"params": params, "batch_stats": stats}, 13)
    state = jcommon.make_state(jmodel, v["params"], v["batch_stats"], jcfg.training)
    mgr = CheckpointManager(jcfg.logging.model_output_path)
    mgr.save_checkpoint(state, epoch=1, metric_value=0.5)
    mgr.wait()
    jtask = JaxTask(model=jmodel, loss_group=jcfg.training.loss_functions, input_keys=keys)

    pcfg = StandardMultimodalConfig.load(cfg_path, run_id=1)
    pmodel = common.build_model_from_config(pcfg.model)
    pmodel.load_state_dict(
        from_jax_variables(v["params"], v["batch_stats"], target=pmodel), strict=True
    )
    torch.save(pmodel.state_dict(), common.checkpoint_path(pcfg, "best"))
    ptask = ClassificationTask(model=pmodel.eval(), loss_group=pcfg.training.loss_functions,
                               input_keys=keys)
    return cfg_path, jcfg, jtask, v, pcfg, ptask


def test_eval_logits_match_mmtpu_for_all_seven_patterns(tiny_run):
    from mmtpu_torch.train.step import make_eval_step

    _, jcfg, jtask, v, pcfg, ptask = tiny_run
    step = make_eval_step(ptask, torch.device("cpu"))
    jl = jcfg.data.build_loader("test", seed=jcfg.experiment.seed)
    pl = pcfg.data.build_loader("test", seed=pcfg.experiment.seed)
    assert sorted(pl.pattern_vocab) == ["a", "at", "atv", "av", "t", "tv", "v"]
    seen = set()
    for jb, pb in zip(jl, pl):
        assert sorted(jb) == sorted(pb)
        for k in jb:
            assert jb[k].tobytes() == pb[k].tobytes(), k
        out = step(pb)
        want = np.asarray(jtask.apply(v, jb, train=False))
        np.testing.assert_allclose(out["logits"].numpy(), want, rtol=TOL, atol=TOL)
        jloss = float(jtask.loss(want, jb, sample_mask=jb["sample_mask"]))
        assert abs(out["loss"].item() - jloss) < TOL
        real = pb["sample_mask"] > 0
        seen |= {pl.pattern_vocab[i] for i in pb["pattern_id"][real]}
        # the masks really zero whole modalities
        for mod in ("audio", "video", "text"):
            assert set(np.unique(pb[f"{mod}_mask"])) <= {0.0, 1.0}
    assert seen == set(pl.pattern_vocab) and len(pl) == 5  # 70 visits in batches of 16


def _run_predict(module, cfg_path, out, cwd):
    from _cli_harness import run_cli_inproc

    code = run_cli_inproc(module, cfg_path, run_id="1", cwd=cwd, extra=["--out", str(out)])
    assert code == 0
    return json.loads(Path(out).read_text())


def test_predict_cli_json_matches_mmtpu(tiny_run, tmp_path):
    from mmtpu_torch.train.step import make_eval_step

    cfg_path, _, _, _, pcfg, ptask = tiny_run
    want = _run_predict("mmtpu.cli.predict", cfg_path, tmp_path / "jax.json", tmp_path)
    got = _run_predict("mmtpu_torch.cli.predict", cfg_path, tmp_path / "port.json", tmp_path)
    assert list(got) == list(want) == ["split", "checkpoint", "accuracy_per_pattern",
                                       "predictions"]
    assert len(got["predictions"]) == len(want["predictions"]) == 70  # pads dropped
    assert got["accuracy_per_pattern"] == want["accuracy_per_pattern"]
    assert sorted(got["accuracy_per_pattern"]) == ["a", "at", "atv", "av", "t", "tv", "v"]

    step = make_eval_step(ptask, torch.device("cpu"))
    logits = torch.cat([
        step(b)["logits"][torch.from_numpy(b["sample_mask"] > 0)]
        for b in pcfg.data.build_loader("test", seed=pcfg.experiment.seed)
    ])
    top2 = logits.topk(2, dim=-1).values
    clear = ((top2[:, 0] - top2[:, 1]) > 2 * TOL).tolist()
    assert sum(clear) > 60
    for c, g, w in zip(clear, got["predictions"], want["predictions"]):
        assert (g["pattern"], g["label"]) == (w["pattern"], w["label"])
        if c:
            assert g["pred"] == w["pred"] and g["correct"] == w["correct"]


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_server_answers_three_modality_requests(tiny_run):
    from mmtpu_torch.cli import serve

    cfg_path = tiny_run[0]
    args = serve.arg_parser().parse_args(["--config", str(cfg_path), "--cpu"])
    predictor, meta = serve.load_model(args)
    assert meta["input_keys"] == ["audio", "video", "text"] and meta["model"] == "UttFusionModel"
    assert meta["input_shapes"] == [["b", 12, 5], ["b", 12, 20], ["b", 12, 768]]
    g = np.random.default_rng(6)
    ins = {"audio": g.normal(size=(5, 12, 5)), "video": g.normal(size=(5, 12, 20)),
           "text": g.normal(size=(5, 12, 768))}
    ins = {k: x.astype(np.float32) for k, x in ins.items()}
    ins["text"][0] = 0.0  # text missing: sent as zeros
    ins["audio"][1] = 0.0
    ins["video"][1] = 0.0
    direct = predictor(**ins)
    assert direct["logits"].shape == (5, 3)
    with serve.ServerThread(predictor, meta, max_batch=4, max_wait_ms=20.0) as st:
        with ThreadPoolExecutor(max_workers=5) as pool:
            rows = list(pool.map(
                lambda i: _post(f"{st.url}/predict", {k: x[i].tolist() for k, x in ins.items()}),
                range(5),
            ))
        batch = _post(f"{st.url}/predict_batch", {k: x.tolist() for k, x in ins.items()})
        with pytest.raises(urllib.error.HTTPError) as err:  # a key left out is refused
            _post(f"{st.url}/predict", {k: ins[k][0].tolist() for k in ("audio", "video")})
        err.value.close()
        assert err.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as err:  # and so is a wrong shape
            _post(f"{st.url}/predict", {**{k: x[0].tolist() for k, x in ins.items()},
                                        "text": ins["text"][0, :5].tolist()})
        err.value.close()
        assert err.value.code == 400
    for i, row in enumerate(rows):
        np.testing.assert_allclose(row["logits"], direct["logits"][i], rtol=TOL, atol=TOL)
        assert row["preds"] == int(direct["preds"][i])
    np.testing.assert_allclose(batch["logits"], direct["logits"], rtol=TOL, atol=TOL)


def test_chip_smoke_mosi_config_is_the_yaml_at_published_widths():
    """chip_smoke.py builds its UttFusion config from a dict shaped like the
    repo's YAML; with the YAML's widths and sizes put back it is the YAML."""
    from chip_smoke import mosi_smoke_config
    from mmtpu_torch.config import StandardMultimodalConfig

    def without_timestamp(d):
        d["logging"].pop("timestamp")
        return d

    raw = mosi_smoke_config(num_samples=64)
    model = raw["model"]
    assert (model["netA"]["hidden_size"], model["netV"]["hidden_size"]) == (64, 64)
    assert model["netT"]["out_channels"] == 128 and model["netC"]["layers"] == [192, 64, 32]
    for net, embd in (("netA", "maxpool"), ("netV", "maxpool")):
        model[net].update(hidden_size=32, embd_method=embd)
    model["netT"] = {"__module_spec__": "textcnn", "input_size": 768, "embd_size": 64,
                     "dropout": 0.5}
    model["netC"] = {"__module_spec__": "fcclassifier", "input_dim": 128,
                     "layers": [64, 64], "output_dim": 3, "dropout": 0.3}
    from_dict = StandardMultimodalConfig.from_parsed(raw, run_id=1).to_dict()
    from_yaml = StandardMultimodalConfig.load(SYNTH_YAML, run_id=1).to_dict()
    assert without_timestamp(from_dict) == without_timestamp(dict(from_yaml))
