"""The port's HDF5 experiment monitor (`mmtpu_torch/monitor`) against
mmtpu's, on the CPU:

- `leaf_stats` against mmtpu's `_leaf_stats` on the same arrays (value
  columns within 1e-5 relative or 1e-6 of max |x|, fractions exactly,
  skewness and kurtosis within 1e-4), and above 2^24 elements, where
  `torch.quantile` stops, against numpy in float64;
- both packages' `train_multimodal` (the synthetic AVMNIST with LeNet
  encoders, and a tiny UttFusion with its clip) and `train_monomodal` (a
  LeNet encoder, `tests/test_torch_port_monitor_mono.py`), monitored at
  intervals 1 / 1 with a buffer that flushes mid-run, from mmtpu's initial
  weights, dropout 0: the two
  `monitor_data.h5` files have the same groups, dataset names and
  `columns` / `layers` attributes, and values within 1e-4 of each
  record's scale (fractions 1e-3, moments 1e-3 relative); a ResNet18's
  records against mmtpu's jitted capture; the two files read through both
  packages' `MonitoringAnalyser` give the same analyses;
- the port's loop streams under a monitor, `--resume` appends, an
  exclusion wins over an inclusion, the drivers with their own steps and
  the stacked engine write no file (as mmtpu's), and a run that asks for
  the monitor without h5py stops before its first step;
- two gloo ranks write the file one process writes (within 1e-6), and
  rank 1 opens none.

No activation name that mmtpu writes is missing in the port on these
models: AVMNIST's head, whose flax modules return their (kernel, bias),
is recorded under mmtpu's `fc_*/__call__/0/{0,1}` names
(`MMTPU_PARAM_MODULES`).
"""

import gc
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _mesh_ranks  # noqa: E402
from _cli_harness import run_cli_inproc  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
VALUES = slice(0, 11)  # l2 … p95
FRACTIONS = [11, 12, 13, 16]
MOMENTS = [14, 15]
MONITORING = """monitoring:
  enabled: true
  gradient_interval: 1
  activation_interval: 1
  buffer_size: 7
"""


def _arrays():
    rng = np.random.default_rng(0)
    return {
        "normal": rng.normal(size=(64, 16)),
        "relu_conv": np.maximum(rng.normal(size=(8, 3, 5, 5)), 0.0),
        "saturating": np.tanh(3.0 * rng.normal(size=(257,))),
        "heavy_tailed": rng.standard_t(3, size=(1000,)) * 1e3,
        "below_1e-7": rng.normal(size=(33,)) * 1e-7,
        "constant": np.full((7,), 0.25),
        "one_element": np.asarray([1.5]),
    }


def _assert_stats(got: np.ndarray, want: np.ndarray, x: np.ndarray, what="",
                  fraction_rtol: float = 0.0) -> None:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.abs(x).max())
    np.testing.assert_allclose(got[VALUES], want[VALUES], rtol=1e-5, atol=1e-6 * scale,
                               err_msg=what)
    np.testing.assert_allclose(got[FRACTIONS], want[FRACTIONS], rtol=fraction_rtol, atol=0,
                               err_msg=what)
    np.testing.assert_allclose(got[MOMENTS], want[MOMENTS], rtol=1e-4, atol=1e-4, err_msg=what)


@pytest.mark.parametrize("case", list(_arrays()))
def test_leaf_stats_match_mmtpu(case):
    from mmtpu.monitor.monitor import STAT_COLUMNS as JAX_COLUMNS
    from mmtpu.monitor.monitor import _leaf_stats

    from mmtpu_torch.monitor.monitor import STAT_COLUMNS, leaf_stats

    assert STAT_COLUMNS == JAX_COLUMNS
    x = _arrays()[case].astype(np.float32)
    got = leaf_stats(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (17,)
    _assert_stats(got.numpy(), np.asarray(_leaf_stats(x)), x, case)


def test_leaf_stats_above_2_24_elements_against_numpy():
    """torch.quantile raises above 2^24 elements; the sort does not."""
    from mmtpu_torch.monitor.monitor import leaf_stats

    x = np.random.default_rng(1).normal(size=2 ** 24 + 5).astype(np.float32)
    got = leaf_stats(torch.from_numpy(x)).numpy()
    d = x.astype(np.float64)
    z = (d - d.mean()) / d.std()
    p5, p25, p50, p75, p95 = np.percentile(d, [5, 25, 50, 75, 95])
    want = [np.linalg.norm(d), d.mean(), d.std(), d.min(), d.max(), np.abs(d).sum(), p50, p5,
            p25, p75, p95, np.mean(np.abs(d) < 1e-7), np.mean(d > 0), np.mean(d < 0),
            np.mean(z ** 3), np.mean(z ** 4) - 3.0, np.mean(np.abs(d) > 0.99)]
    want = np.asarray(want, np.float32)
    # a fraction is the float32 count times float32(1/n), as mmtpu's: within
    # two float32 ulps of numpy's count / n
    _assert_stats(got, want, x, fraction_rtol=2.4e-7)


# -- the monitored CLI runs, both packages ----------------------------------------------


def _h5(path: Path) -> dict:
    """group → name → (data, attrs) of a monitor file."""
    import h5py

    out = {}
    with h5py.File(path, "r") as f:
        for group in f:
            recs = {}

            def visit(name, item, recs=recs):
                if isinstance(item, h5py.Dataset):
                    recs[name] = (np.asarray(item), {k: str(v) for k, v in item.attrs.items()})

            f[group].visititems(visit)
            out[group] = recs
    return out


def _assert_same_file(a: dict, b: dict, rel: float = 1e-4, moments: float = 1e-3,
                      fractions: float = 1e-3) -> None:
    """Same groups, names and attributes; every value within `rel` of its
    record's largest magnitude; skewness and kurtosis within `moments` of
    max(1, |value|) (they amplify a gradient's last bits: through LeNet's
    BatchNorm the packages' step-0 gradients give kurtoses 1.7e-4 apart);
    the fractions within `fractions` (an element within rounding of the 0,
    1e-7 or 0.99 threshold may fall on either side: 2 of 4,096 in AVMNIST's
    fc_fusion gradient). A record whose tensor (its max |x|) is below 1e-6 of the largest in its
    capture is rounding noise (a conv bias before BatchNorm, whose gradient
    is 0 but for ~1e-9 that differs between the packages): its values are
    held to `rel` of the capture's largest max |x|, and its fractions and
    moments, which describe the noise, are not."""
    assert set(a) == set(b) == {"gradients", "activations", "weights", "convergence"}
    for group in a:
        assert sorted(a[group]) == sorted(b[group]), group
        captures = {}
        for name, (data, _) in b[group].items():
            if data.shape == (17,):
                prefix = _capture(name)
                captures[prefix] = max(captures.get(prefix, 0.0), float(np.abs(data[3:5]).max()))
        for name, (data, attrs) in a[group].items():
            other, other_attrs = b[group][name]
            assert attrs == other_attrs, (group, name)
            assert data.shape == other.shape, (group, name)
            scale = max(float(np.abs(other).max()), 1e-12)
            if other.shape == (17,):
                top = captures[_capture(name)]
                if float(np.abs(other[3:5]).max()) < 1e-6 * top:
                    data, other, scale = data[VALUES], other[VALUES], top
                else:
                    np.testing.assert_allclose(data[MOMENTS], other[MOMENTS], rtol=moments,
                                               atol=moments, err_msg=f"{group}/{name}")
                    np.testing.assert_allclose(data[FRACTIONS], other[FRACTIONS], rtol=0,
                                               atol=fractions, err_msg=f"{group}/{name}")
                    data, other = data[VALUES], other[VALUES]
            np.testing.assert_allclose(data, other, rtol=0, atol=rel * scale,
                                       err_msg=f"{group}/{name}")


def _capture(name: str) -> str:
    """`epoch_N/step_M` (or `epoch_N` for weights) of a record's name."""
    parts = name.split("/")
    return "/".join(parts[:2] if parts[1].startswith("step_") else parts[:1])


def _config(dst: Path, src: str, out_root: Path, edits=()) -> Path:
    text = (REPO / "configs" / src).read_text()
    for prefix in ('"./experiments_output', '"experiments_output'):
        text = text.replace(prefix, f'"{out_root}')
    for old, new in edits:
        assert old in text, old
        text = text.replace(old, new)
    dst.write_text(text)
    return dst


# Adam's ε at 1e-3: the conv biases before BatchNorm get gradients of ~1e-9,
# numerical noise that differs between the packages and that ε = 1e-8 would
# turn into updates of ±lr
EPS = ("lr: 0.001\n", "lr: 0.001\n      eps: 0.001\n")


def _avmnist(dst, out_root):
    """configs/avmnist/synthetic_dp.yaml (it sets monitor_path), monitored,
    with 32 train samples (one step an epoch)."""
    text = _config(dst, "avmnist/synthetic_dp.yaml", out_root,
                   [("num_samples: 96", "num_samples: 32"), EPS]).read_text()
    dst.write_text(text + "\n" + MONITORING)
    return dst


MONITOR_PATH = ('  metrics_path: "{root}/{{experiment_name}}/metrics/{{run_id}}"\n',
                '  metrics_path: "{root}/{{experiment_name}}/metrics/{{run_id}}"\n'
                '  monitor_path: "{root}/{{experiment_name}}/monitor/{{run_id}}"\n')


def _with_monitor(dst, src, out_root, edits):
    old, new = (s.format(root=out_root) for s in MONITOR_PATH)
    return _config(dst, src, out_root, [*edits, (old, new),
                                        ("monitoring:\n  enabled: false", MONITORING.strip())])


def _uttfusion(dst, out_root):
    """configs/mosi/synthetic_utt_fusion.yaml at hidden 8, T = 6, dropout 0,
    24 train samples in batches of 16 (a padded tail), 12 eval samples."""
    return _with_monitor(dst, "mosi/synthetic_utt_fusion.yaml", out_root, [
        ("hidden_size: 32", "hidden_size: 8"),
        ("embd_size: 64\n    dropout: 0.5", "embd_size: 8\n    out_channels: 8\n    dropout: 0.0"),
        ("input_dim: 128\n    layers: [64, 64]", "input_dim: 24\n    layers: [16, 8]"),
        ("dropout: 0.3", "dropout: 0.0"),
        ("batch_size: 32", "batch_size: 16"), EPS,
        ("num_samples: 128", "num_samples: 24\n        seq_len: 6"),
        ("num_samples: 64", "num_samples: 12\n        seq_len: 6")])


def _monomodal(dst, out_root):
    """configs/avmnist/synthetic_mono_audio.yaml with a monitor_path, a LeNet
    audio encoder in its ResNet18's place (whose names
    `test_resnet_records_are_named_as_mmtpu` holds), one epoch of one step
    (16 samples), 16 eval samples."""
    return _with_monitor(dst, "avmnist/synthetic_mono_audio.yaml", out_root, [
        ("audio_encoder: !ResNet18\n    in_channels: 1\n    hidden_dim: 64",
         "audio_encoder: !LeNetEncoder\n    in_channels: 1\n    hidden_dim: 8"),
        ("output_dim: 64", "output_dim: 8"),
        ("batch_size: 64", "batch_size: 16"), ("num_samples: 256", "num_samples: 16"),
        ("num_samples: 128", "num_samples: 16"), ("epochs: 2", "epochs: 1"),
        ("lr: 0.0005\n", "lr: 0.0005\n      eps: 0.001\n")])


CASES = {
    "avmnist": ("train_multimodal", _avmnist, "Synthetic_DP"),
    "uttfusion": ("train_multimodal", _uttfusion, "Synthetic_MOSI_UttFusion"),
    "monomodal": ("train_monomodal", _monomodal, "Synthetic_AVMNIST_Audio_Encoder"),
}


# (train steps, epochs) of each case's run
STEPS = {"avmnist": (2, 2), "uttfusion": (4, 2), "monomodal": (1, 1)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    yield from monitored_runs(tmp_path_factory, ("avmnist", "uttfusion"))


def monitored_runs(tmp_path_factory, cases):
    """Each case through mmtpu's CLI, then the port's from mmtpu's initial
    weights (carried by `from_jax_variables`): the body of a module's
    fixture (`tests/test_torch_port_monitor_mono.py` runs the monomodal
    case on a worker of its own)."""
    import jax

    from mmtpu.cli import common as jax_common

    from mmtpu_torch.checkpoints import from_jax_variables
    from mmtpu_torch.cli import common

    mp = pytest.MonkeyPatch()
    init = {}
    real_jax_init = jax_common.init_model

    def jax_spy(model, sample, seed):
        params, stats = real_jax_init(model, sample, seed)
        init["v"] = [jax.tree_util.tree_map(np.asarray, t) for t in (params, stats)]
        return params, stats

    def port_init(model, seed, device):
        params, stats = init["v"]
        model.load_state_dict(from_jax_variables(params, stats or None, target=model))
        torch.manual_seed(int(seed))
        return model.to(device)

    out = {}
    root = tmp_path_factory.mktemp("monitored")
    try:
        mp.setattr(jax_common, "init_model", jax_spy)
        mp.setattr(common, "init_model", port_init)
        for case in cases:
            cli, make, name = CASES[case]
            for pkg in ("mmtpu", "mmtpu_torch"):
                work = root / case / pkg
                work.mkdir(parents=True)
                cfg = make(work / "config.yaml", work / "out")
                # one device: an 8-device CPU mesh can stall mmtpu's collectives on few cores
                assert run_cli_inproc(f"{pkg}.cli.{cli}", cfg, run_id="1",
                                      extra=("--data-parallel", "1")) == 0
                gc.collect()  # mmtpu never closes its monitor: its file closes with it
                out[case, pkg] = work / "out" / name / "monitor" / "1" / "monitor_data.h5"
                out[case, pkg, "config"] = cfg
            params, stats = init["v"]
            out[case, "weights"] = root / case / "initial.pt"
            torch.save([{"params": params, "batch_stats": stats}], out[case, "weights"])
    finally:
        mp.undo()
    yield out
    shutil.rmtree(root, ignore_errors=True)


@pytest.mark.parametrize("case", ["avmnist", "uttfusion"])
def test_monitored_run_writes_mmtpus_file(runs, case):
    check_monitored_file(runs, case)


def check_monitored_file(runs, case):
    """The port's file against mmtpu's (`_assert_same_file`), and every
    step and epoch of the run recorded."""
    mine, theirs = _h5(runs[case, "mmtpu_torch"]), _h5(runs[case, "mmtpu"])
    _assert_same_file(mine, theirs)
    steps, epochs = STEPS[case]
    for group in ("gradients", "activations"):  # every step captured, step 0 included
        assert {n.split("/")[1] for n in mine[group]} == {f"step_{i}" for i in range(steps)}
    assert {n.split("/")[0] for n in mine["weights"]} == {f"epoch_{i + 1}" for i in range(epochs)}
    assert any(n.endswith("__spectral") for n in theirs["weights"])
    if case == "avmnist":
        assert "epoch_1/step_0/fc_fusion/__call__/0/0" in mine["activations"]


@pytest.mark.parametrize("case", ["avmnist", "uttfusion"])
def test_analysers_agree_on_both_files(runs, case):
    """Both packages' analysers read each file alike; the analyses of the
    two UttFusion files agree (AVMNIST's hold noise records, above)."""
    from mmtpu.monitor.analysis import MonitoringAnalyser as JaxAnalyser

    from mmtpu_torch.monitor import MonitoringAnalyser

    def analyses(cls, path):
        with cls(path) as an:
            return {"summary": an.get_summary_statistics(), "traj": an.gradient_stats(),
                    "evolution": an.get_temporal_evolution("weights"), "flags": an.summary(),
                    "activations": an.activation_stats(), "weights": an.weight_stats()}

    for path in (runs[case, "mmtpu"], runs[case, "mmtpu_torch"]):
        assert analyses(MonitoringAnalyser, path) == analyses(JaxAnalyser, path)
    if case == "uttfusion":
        mine, theirs = (analyses(MonitoringAnalyser, runs[case, p])
                        for p in ("mmtpu_torch", "mmtpu"))
        assert mine["flags"] == theirs["flags"]
        _close_tree(mine["summary"], theirs["summary"])


def _close_tree(a, b, where=""):
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _close_tree(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, float):
        assert a == pytest.approx(b, rel=1e-3, abs=1e-4), where
    else:
        assert a == b, where


def test_resume_appends_to_the_file(tmp_path):
    from mmtpu_torch.cli import common
    from mmtpu_torch.config import StandardMultimodalConfig

    cfg = StandardMultimodalConfig.load(_avmnist(tmp_path / "c.yaml", tmp_path / "out"), 1)
    mon = common.make_monitor(cfg)
    mon.storage.append("gradients", "epoch_1/step_0/x", np.zeros(3, np.float32))
    mon.close()
    path = Path(cfg.logging.monitor_path) / "monitor_data.h5"
    resumed = common.make_monitor(cfg, resume=True)  # --resume
    resumed.storage.append("gradients", "epoch_2/step_0/x", np.ones(3, np.float32))
    resumed.close()
    assert sorted(_h5(path)["gradients"]) == ["epoch_1/step_0/x", "epoch_2/step_0/x"]
    common.make_monitor(cfg).close()  # a fresh run truncates
    assert _h5(path)["gradients"] == {}
    cfg.logging.monitor_path = None
    assert common.make_monitor(cfg) is None  # enabled without a path: no monitor, as mmtpu


def test_exclusion_wins_over_inclusion(tmp_path):
    from mmtpu.config.monitor import MonitorConfig as JaxConfig
    from mmtpu.monitor.monitor import ExperimentMonitor as JaxMonitor

    from mmtpu_torch.config import MonitorConfig
    from mmtpu_torch.monitor import ExperimentMonitor, MemoryStorage

    names = ["encoder/fc_0/kernel", "encoder/bn_1/scale", "head/kernel", "encoder/Dropout_0"]
    for kw in ({"include_layers": ["encoder"]}, {"include_layers": ["bn"]},
               {"exclude_layers": ["head"]}, {"include_layers": ["fc"], "exclude_layers": ["fc_0"]}):
        mine = ExperimentMonitor(MonitorConfig(enabled=True, **kw), "", storage=MemoryStorage())
        theirs = JaxMonitor(JaxConfig(enabled=True, **kw), str(tmp_path))
        assert [mine._keep(n) for n in names] == [theirs._keep(n) for n in names], kw
        theirs.close()
    mine = ExperimentMonitor(MonitorConfig(enabled=True, include_layers=["encoder"]), "",
                             storage=MemoryStorage())
    assert mine._keep("encoder/fc_0/kernel") and not mine._keep("encoder/bn_1/scale")


def test_the_loop_streams_under_a_monitor_and_steps_in_mmtpus_order(tmp_path, monkeypatch):
    """Streaming (no upload), step 0 captured, gradients before the clip."""
    from mmtpu_torch.train import loop as loop_mod
    from mmtpu_torch.train import step as step_mod

    events = []
    real_clip = step_mod.clip_by_global_norm
    monkeypatch.setattr(step_mod, "clip_by_global_norm",
                        lambda *a: events.append("clip") or real_clip(*a))
    real_loop = loop_mod.TrainLoop.__init__

    def spy_loop(self, *a, **kw):
        real_loop(self, *a, **kw)
        spy_loop.loop = self
        mon = self.monitor
        for name in ("record_gradients", "record_activations", "step", "end_epoch"):
            real = getattr(mon, name)
            setattr(mon, name, lambda *a, _r=real, _n=name: events.append(_n) or _r(*a))

    monkeypatch.setattr(loop_mod.TrainLoop, "__init__", spy_loop)
    cfg = _uttfusion(tmp_path / "u.yaml", tmp_path / "out")
    text = cfg.read_text().replace("activation_interval: 1", "activation_interval: 2")
    cfg.write_text(text.replace("epochs: 2", "epochs: 1"))
    assert run_cli_inproc("mmtpu_torch.cli.train_multimodal", cfg, run_id="1") == 0
    assert spy_loop.loop._resident == {}
    assert events == ["record_gradients", "clip", "record_activations", "step",
                      "record_gradients", "clip", "step", "end_epoch"]


def test_drivers_with_their_own_steps_write_no_monitor_file(tmp_path, monkeypatch):
    """mmtpu passes no monitor to C-MAM, MMIN, RedCore, Self-MM or the
    stacked engine (only its train_multimodal's and train_monomodal's
    standard loops take `make_monitor`): `monitoring.enabled` has no
    effect there. The port's MMIN and `--stacked-runs` build none and
    write no file."""
    from mmtpu_torch.cli import common
    from mmtpu_torch.train.loop import TrainLoop

    built = []
    real = common.make_monitor
    monkeypatch.setattr(common, "make_monitor", lambda *a, **k: built.append(1) or real(*a, **k))
    small = [("num_samples: 96", "num_samples: 32")]
    mmin = _with_monitor(tmp_path / "mmin.yaml", "mosi/synthetic_mmin.yaml", tmp_path / "out",
                         small)
    stacked = _with_monitor(tmp_path / "runs.yaml", "avmnist/synthetic_runs.yaml",
                            tmp_path / "out", small)
    for cfg, extra in ((mmin, ()), (stacked, ("--stacked-runs", "2"))):
        assert run_cli_inproc("mmtpu_torch.cli.train_multimodal", cfg, run_id="1",
                              extra=("--epochs", "1", *extra)) == 0
    assert built == [] and list(tmp_path.rglob("monitor_data.h5")) == []
    with pytest.raises(ValueError, match="step_builders"):
        TrainLoop(task=None, state=None, loaders={}, recorder=None, checkpoint_manager=None,
                  device=torch.device("cpu"), epochs=1, step_builders=(None, None),
                  monitor=object())


def test_without_h5py_the_run_stops_before_its_first_step(tmp_path, monkeypatch):
    from mmtpu_torch.train import loop as loop_mod

    monkeypatch.setitem(sys.modules, "h5py", None)  # import h5py raises ImportError
    monkeypatch.setattr(loop_mod.TrainLoop, "train_epoch",
                        lambda *a: pytest.fail("trained without the monitor"))
    cfg = _avmnist(tmp_path / "c.yaml", tmp_path / "out")
    with pytest.raises(ImportError, match="monitoring.enabled needs h5py"):
        run_cli_inproc("mmtpu_torch.cli.train_multimodal", cfg, run_id="1")


def test_two_ranks_write_one_process_file_and_rank_1_opens_none(runs, tmp_path):
    from mmtpu_torch.parallel import MeshConfig, create_mesh
    from mmtpu_torch.parallel.launch import launch

    cfg = runs["avmnist", "mmtpu_torch", "config"]
    text = cfg.read_text().replace(str(cfg.parent / "out"), str(tmp_path / "out"))
    cfg = tmp_path / "config.yaml"
    cfg.write_text(text)
    mesh = create_mesh(MeshConfig(data_parallel=2), devices=[torch.device("cpu")] * 2)
    argv = ["--config", str(cfg), "--run_id", "1", "--cpu", "--data-parallel", "2"]
    assert launch(mesh, _mesh_ranks.probed_main,
                  ("mmtpu_torch.cli.train_multimodal", argv, str(tmp_path),
                   str(runs["avmnist", "weights"])), timeout=120) == 0
    two = tmp_path / "out" / "Synthetic_DP" / "monitor" / "1" / "monitor_data.h5"
    _assert_same_file(_h5(two), _h5(runs["avmnist", "mmtpu_torch"]), rel=1e-6, moments=1e-4,
                      fractions=0.0)
    writes = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)["writes"]
              for r in range(2)]
    assert [w for w in writes[0] if w.endswith(".h5")] == [str(two)]
    assert writes[1] == []


def test_maxpool_splits_the_gradient_of_tied_steps_as_mmtpu():
    """An LSTM over a zeroed (missing) input settles on one state, so its
    maxpool over time has tied maxima: jnp.max splits their gradient
    evenly, and so must the port (the monitored UttFusion's `wi/bias`
    gradients showed it)."""
    import jax
    import jax.numpy as jnp

    from mmtpu.models import build_module as jax_build

    from mmtpu_torch.checkpoints import from_jax_variables
    from mmtpu_torch.models.registry import build_module

    x = np.random.default_rng(0).normal(size=(4, 12, 5)).astype(np.float32)
    x[1:3] = 0.0
    jm = jax_build("lstmencoder", input_size=5, hidden_size=8, embd_method="maxpool")
    params = jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x))["params"]
    want = jax.grad(lambda p: jnp.sum(jm.apply({"params": p}, jnp.asarray(x)) ** 2))(params)
    pm = build_module("lstmencoder", input_size=5, hidden_size=8, embd_method="maxpool")
    pm.load_state_dict(from_jax_variables(jax.tree_util.tree_map(np.asarray, params), target=pm))
    (pm(torch.from_numpy(x)) ** 2).sum().backward()
    want = from_jax_variables(jax.tree_util.tree_map(np.asarray, want))
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def test_resnet_records_are_named_as_mmtpu():
    """A ResNet18 encoder's records (`layer1_0/conv1`, `downsample_conv`,
    `downsample_bn` left out with the other BatchNorms): the port's
    activation capture and parameter statistics against mmtpu's
    `capture_intermediates` and `tree_stats` (jitted here) on the same
    weights and input, names equal and values within 1e-4 of each record's
    scale."""
    import jax
    import jax.numpy as jnp

    from mmtpu.models import build_module as jax_build
    from mmtpu.monitor.monitor import tree_stats

    from mmtpu_torch.checkpoints import from_jax_variables
    from mmtpu_torch.config import MonitorConfig
    from mmtpu_torch.models.registry import build_module
    from mmtpu_torch.monitor import ExperimentMonitor, MemoryStorage
    from mmtpu_torch.monitor.monitor import (capture_activations, mmtpu_parameters,
                                             named_stats, to_host)

    x = np.random.default_rng(2).normal(size=(4, 32, 94)).astype(np.float32)
    jm = jax_build("monomodal_encoder", output_dim=8, num_classes=10,
                   encoder=jax_build("resnet18", in_channels=1, hidden_dim=8))
    v = jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x), train=False)
    capture = jax.jit(lambda v, x: tree_stats(jm.apply(
        v, x, train=False, capture_intermediates=True, mutable=["intermediates"])[1][
        "intermediates"]))
    pm = build_module("monomodal_encoder", output_dim=8, num_classes=10,
                      encoder=build_module("resnet18", in_channels=1, hidden_dim=8))
    pm.load_state_dict(from_jax_variables(*(jax.tree_util.tree_map(np.asarray, v[k])
                                            for k in ("params", "batch_stats")), target=pm))
    keep = ExperimentMonitor(MonitorConfig(enabled=True), "", storage=MemoryStorage())._keep
    want = {"activations": {k: np.asarray(s) for k, s in capture(v, jnp.asarray(x)).items()
                            if keep(k)},
            "weights": {k: np.asarray(s) for k, s in jax.jit(tree_stats)(v["params"]).items()}}
    got = {"activations": to_host(capture_activations(pm, [torch.from_numpy(x)], keep)),
           "weights": to_host(named_stats(mmtpu_parameters(pm)))}
    assert "encoder/layer2_0/downsample_conv/__call__/0" in got["activations"]
    assert "encoder/layer2_0/downsample_conv/kernel" in got["weights"]
    for group in want:
        assert sorted(got[group]) == sorted(want[group]), group
        for name, row in want[group].items():
            np.testing.assert_allclose(got[group][name], row, rtol=0,
                                       atol=1e-4 * max(float(np.abs(row).max()), 1e-12),
                                       err_msg=f"{group}/{name}")
