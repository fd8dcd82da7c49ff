"""The port's stacked engine (`mmtpu_torch/train/stacked.py`,
`mmtpu_torch/cli/stacked_cv.py`) against mmtpu's vmapped steps and CLI, and
against the port's own separate runs, on the CPU, at the widths of mmtpu's
`tests/test_stacked.py` (an FcClassifier 12→16→4, K = 3, batch 16).

- three stacked train steps against mmtpu's `make_stacked_train_step` and
  against K separate port steps: losses, parameters, Adam moments, the
  per-member counts, BatchNorm statistics (1e-5); the other optimizers, the
  per-member LR scale and clip against separate port steps;
- the dead-step guard with members of unequal length; the empty-fold error;
- every route case of mmtpu's `tests/test_stacked.py`;
- `--stacked-folds` on `configs/avmnist/synthetic_cv.yaml` and
  `--stacked-runs 2` on `synthetic_runs.yaml` against the port's sequential
  runs and mmtpu's CLI from mmtpu's initial weights, in dropout-0 copies of
  the configs (the stacked members' dropout masks are not their separate
  runs', ROADMAP §3): records at 1e-4, the same files and keys;
- a stacked UttFusion train step through the `lstm` vmap rule and a stacked
  AVMNIST eval through the `fused_mlp` vmap rule (the operators' CPU
  versions) against mmtpu's vmapped steps (1e-5).
"""

import importlib
import json
import shutil
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _cli_harness import run_cli_inproc  # noqa: E402

from mmtpu.cli import common as jax_common  # noqa: E402
from mmtpu.config.optim import OptimizerConfig as JaxOptimizerConfig  # noqa: E402
from mmtpu.models import build_module as jax_build_module  # noqa: E402
from mmtpu.train import stacked as jax_stacked  # noqa: E402
from mmtpu.train.losses import LossFunctionGroup as JaxLossGroup  # noqa: E402
from mmtpu.train.optim import build_optimizer as jax_build_optimizer  # noqa: E402
from mmtpu.train.state import TrainState as JaxTrainState  # noqa: E402
from mmtpu.train.step import ClassificationTask as JaxTask  # noqa: E402
from mmtpu_torch.checkpoints import from_jax_variables  # noqa: E402
from mmtpu_torch.cli import common, stacked_cv, train_multimodal  # noqa: E402
from mmtpu_torch.config.optim import OptimizerConfig  # noqa: E402
from mmtpu_torch.data.avmnist import SyntheticAVMNIST  # noqa: E402
from mmtpu_torch.data.loader import BatchLoader  # noqa: E402
from mmtpu_torch.models import build_module  # noqa: E402
from mmtpu_torch.train.losses import LossFunctionGroup  # noqa: E402
from mmtpu_torch.train.optim import build_optimizer, set_lr_scale  # noqa: E402
from mmtpu_torch.train.stacked import (  # noqa: E402
    StackedLoaderGroup,
    StackedModel,
    stack_batches,
)
from mmtpu_torch.train.state import TrainState  # noqa: E402
from mmtpu_torch.train.step import ClassificationTask, make_eval_step, make_train_step  # noqa: E402

ops_mlp = importlib.import_module("mmtpu_torch.ops.fused_mlp")
ops_lstm = importlib.import_module("mmtpu_torch.ops.lstm")
REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
TOL = 1e-5
K = 3
LOSS = {"ce": {"loss_name": "cross_entropy", "weight": 1.0}}


def _adam(use_bn):
    """Adam at lr 1e-2; with BatchNorm at eps 1e-3, where a near-zero
    gradient's sign under eps 1e-8 is float noise (see
    tests/test_torch_port_train.py)."""
    return {"lr": 1e-2, **({"eps": 1e-3} if use_bn else {})}


def _jax_runs(k, use_bn=False):
    """mmtpu's `build_runs`: one model and optimizer, k seeds of parameters."""
    model = jax_build_module("fcclassifier", input_dim=12, layers=[16], output_dim=4,
                             dropout=0.0, use_bn=use_bn)
    task = JaxTask(model=model, loss_group=JaxLossGroup.from_dict(LOSS), input_keys=("x",))
    v0 = model.init(jax.random.PRNGKey(0), jnp.zeros((2, 12)))
    tx, _ = jax_build_optimizer(
        JaxOptimizerConfig(name="Adam", default_kwargs=_adam(use_bn)), v0["params"])
    states = []
    for seed in range(k):
        v = model.init(jax.random.PRNGKey(seed), jnp.zeros((2, 12)))
        states.append(JaxTrainState.create(apply_fn=model.apply, params=v["params"], tx=tx,
                                           batch_stats=v.get("batch_stats", {})))
    return states, task


def _port_runs(jax_states, use_bn=False, optimizer="Adam", kwargs=None, clip=None):
    """The port's members from mmtpu's parameters (and BatchNorm statistics)."""
    states = []
    for js in jax_states:
        m = build_module("fcclassifier", input_dim=12, layers=[16], output_dim=4, dropout=0.0,
                         use_bn=use_bn)
        m.load_state_dict(from_jax_variables(
            jax.tree_util.tree_map(np.asarray, js.params),
            jax.tree_util.tree_map(np.asarray, js.batch_stats) or None, target=m), strict=True)
        opt, _ = build_optimizer(OptimizerConfig(name=optimizer,
                                                 default_kwargs=kwargs or _adam(use_bn)), m)
        states.append(TrainState(model=m, optimizer=opt, clip=clip))
    task = ClassificationTask(model=states[0].model, loss_group=LossFunctionGroup.from_dict(LOSS),
                              input_keys=("x",))
    return states, task


def _batch(seed, B=16, padded_from=None):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 4, B)
    b = {"x": (rng.normal(size=(B, 12)) + labels[:, None]).astype(np.float32),
         "labels": labels, "sample_mask": np.ones(B, np.float32)}
    if padded_from is not None:
        for key in b:
            b[key][padded_from:] = 0
    return b


def _separate(states, task, batches_per_member):
    """Each member's own port steps on its own batches."""
    losses = []
    for st, batches in zip(states, batches_per_member):
        step = make_train_step(
            ClassificationTask(model=st.model, loss_group=task.loss_group, input_keys=("x",)),
            st, CPU)
        losses.append([float(step(b)["loss"]) for b in batches])
    return losses


def _unstack(tree, k):
    return jax_stacked.unstack_tree(jax.device_get(tree), k)


def _jax_moments(opt_state):
    """mmtpu's Adam state (one group: the whole tree)."""
    return next(s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: type(x).__name__ == "ScaleByAdamState")
        if type(s).__name__ == "ScaleByAdamState")


@pytest.mark.parametrize("use_bn", [False, True])
def test_stacked_steps_match_mmtpu_and_separate_port_steps(use_bn):
    jstates, jtask = _jax_runs(K, use_bn)
    batches = [[_batch(100 + 10 * s + t, padded_from=12 if t == 1 else None) for t in range(3)]
               for s in range(K)]
    stacked_j = jax_stacked.stack_states(jstates)
    jstep = jax_stacked.make_stacked_train_step(jtask, donate=False)
    rngs = jax_stacked.stacked_rngs(jax.random.PRNGKey(7), K)
    pstates, ptask = _port_runs(jstates, use_bn)
    sep_states, _ = _port_runs(jstates, use_bn)
    stacked_p = StackedModel(ptask, pstates)
    for t in range(3):
        sb = stack_batches([batches[s][t] for s in range(K)])
        stacked_j, jout = jstep(stacked_j, jax_stacked.stack_batches(
            [batches[s][t] for s in range(K)]), rngs)
        pout = stacked_p.train_step(sb, CPU)
        np.testing.assert_allclose(pout["loss"].numpy(), np.asarray(jout["loss"]), rtol=TOL)
    sep_losses = _separate(sep_states, ptask, batches)
    np.testing.assert_allclose(pout["loss"].numpy(), [ls[-1] for ls in sep_losses], rtol=TOL)
    for k, js in enumerate(_unstack(stacked_j, K)):
        member = stacked_p.member_state(k)
        want = from_jax_variables(jax.tree_util.tree_map(np.asarray, js.params),
                                  jax.tree_util.tree_map(np.asarray, js.batch_stats) or None,
                                  target=member.model)
        got, sep = member.model.state_dict(), sep_states[k].model.state_dict()
        for name, w in want.items():
            if name.endswith("num_batches_tracked"):
                assert int(got[name]) == int(sep[name]) == 3
                continue
            np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0, atol=TOL,
                                       err_msg=name)
            np.testing.assert_allclose(got[name].numpy(), sep[name].numpy(), rtol=0, atol=TOL,
                                       err_msg=name)
        adam = _jax_moments(js.opt_state)
        mu = from_jax_variables(jax.tree_util.tree_map(np.asarray, adam.mu))
        nu = from_jax_variables(jax.tree_util.tree_map(np.asarray, adam.nu))
        names = {id(p): n for n, p in member.model.named_parameters()}
        sep_by_name = dict(sep_states[k].model.named_parameters())
        for p, st in member.optimizer.state.items():
            n = names[id(p)]
            sep_st = sep_states[k].optimizer.state[sep_by_name[n]]
            for key, want_m in (("exp_avg", mu[n]), ("exp_avg_sq", nu[n])):
                np.testing.assert_allclose(st[key].numpy(), want_m.numpy(), rtol=0, atol=TOL)
                np.testing.assert_allclose(st[key].numpy(), sep_st[key].numpy(), rtol=0,
                                           atol=TOL)
            assert int(st["step"]) == int(sep_st["step"]) == int(adam.count) == 3
        assert member.step == 3


def test_stacked_eval_matches_separate_and_mmtpu():
    jstates, jtask = _jax_runs(K)
    batches = [_batch(200 + s, padded_from=10) for s in range(K)]
    jout = jax_stacked.make_stacked_eval_step(jtask)(
        jax_stacked.stack_states(jstates), jax_stacked.stack_batches(batches))
    pstates, ptask = _port_runs(jstates)
    out = StackedModel(ptask, pstates).eval_step(stack_batches(batches), CPU)
    np.testing.assert_allclose(out["loss"].numpy(), np.asarray(jout["loss"]), rtol=TOL)
    for s in range(K):
        sep = make_eval_step(ClassificationTask(model=pstates[s].model, loss_group=ptask.loss_group,
                                                input_keys=("x",)), CPU)(batches[s])
        np.testing.assert_array_equal(out["preds"][s].numpy(), sep["preds"].numpy())
        np.testing.assert_array_equal(out["preds"][s].numpy(), np.asarray(jout["preds"][s]))


@pytest.mark.parametrize("optimizer,kwargs", [
    ("Adam", {"lr": 1e-2, "weight_decay": 1e-3}),
    ("AdamW", {"lr": 1e-2, "weight_decay": 1e-2}),
    ("SGD", {"lr": 1e-2, "momentum": 0.9, "nesterov": True, "weight_decay": 1e-3}),
    ("RMSprop", {"lr": 1e-3, "momentum": 0.5}),
    ("Adagrad", {"lr": 1e-2}),
    ("Adamax", {"lr": 1e-2}),
    ("Adadelta", {"lr": 1.0, "weight_decay": 1e-3}),
    ("sparse_adam", {"lr": 1e-2}),
])
def test_stacked_optimizers_match_separate_port_steps(optimizer, kwargs):
    jstates, _ = _jax_runs(2)
    pstates, ptask = _port_runs(jstates, optimizer=optimizer, kwargs=kwargs)
    sep_states, _ = _port_runs(jstates, optimizer=optimizer, kwargs=kwargs)
    batches = [[_batch(300 + 10 * s + t) for t in range(3)] for s in range(2)]
    stacked = StackedModel(ptask, pstates)
    for t in range(3):
        stacked.train_step(stack_batches([batches[s][t] for s in range(2)]), CPU)
    _separate(sep_states, ptask, batches)
    for k in range(2):
        got = stacked.member_state(k)
        for (n, p), q in zip(sep_states[k].model.named_parameters(), got.model.parameters()):
            np.testing.assert_allclose(q.detach().numpy(), p.detach().numpy(), rtol=0, atol=TOL,
                                       err_msg=n)


def test_lr_scale_and_clip_are_per_member():
    """Member 1 at half the lr and both clipped at a norm their gradients
    exceed: each equals its separate run with `set_lr_scale` and the clip."""
    jstates, _ = _jax_runs(2)
    pstates, ptask = _port_runs(jstates, clip=0.05)
    sep_states, _ = _port_runs(jstates, clip=0.05)
    set_lr_scale(sep_states[1].optimizer, 0.5)
    stacked = StackedModel(ptask, pstates)
    stacked.optimizer.lr_scale.copy_(torch.tensor([1.0, 0.5]))
    batches = [[_batch(400 + 10 * s + t) for t in range(2)] for s in range(2)]
    for t in range(2):
        stacked.train_step(stack_batches([batches[s][t] for s in range(2)]), CPU)
    _separate(sep_states, ptask, batches)
    for k in range(2):
        got = stacked.member_state(k)
        for (n, p), q in zip(sep_states[k].model.named_parameters(), got.model.parameters()):
            np.testing.assert_allclose(q.detach().numpy(), p.detach().numpy(), rtol=0, atol=TOL,
                                       err_msg=n)


def test_dead_steps_leave_a_member_untouched_and_unequal_lengths_match():
    """Member 1 has two batches, member 0 three: at the third lockstep step
    member 1 re-feeds its last batch with a zero mask and keeps its
    parameters, BatchNorm statistics, Adam state and count exactly; both end
    as their separate runs."""
    jstates, _ = _jax_runs(2, use_bn=True)
    pstates, ptask = _port_runs(jstates, use_bn=True)
    sep_states, _ = _port_runs(jstates, use_bn=True)
    stacked = StackedModel(ptask, pstates)
    batches = [[_batch(500 + t) for t in range(3)], [_batch(510 + t) for t in range(2)]]
    loaders = [batches[0], batches[1]]
    steps = list(StackedLoaderGroup(loaders))
    assert len(steps) == 3 and steps[2]["sample_mask"][1].sum() == 0
    for sb in steps[:2]:
        stacked.train_step(sb, CPU)
    before = {k: v.clone() for k, v in stacked.member_state(1).model.state_dict().items()}
    opt_before = {k: v.clone() for k, v in stacked.optimizer.state[
        next(iter(stacked.params))].items()}
    stacked.train_step(steps[2], CPU)
    after = stacked.member_state(1)
    for k, v in after.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    for k, v in stacked.optimizer.state[next(iter(stacked.params))].items():
        assert torch.equal(v[1], opt_before[k][1]), k
    assert stacked.optimizer.count.tolist() == [3, 2] and after.step == 2
    _separate(sep_states, ptask, batches)
    for k in range(2):
        got = stacked.member_state(k).model.state_dict()
        for n, w in sep_states[k].model.state_dict().items():
            np.testing.assert_allclose(got[n].numpy(), w.numpy(), rtol=0, atol=TOL, err_msg=n)


def test_loader_group_pads_exhausted_folds():
    loaders = [BatchLoader(SyntheticAVMNIST(split="train", num_samples=n,
                                            selected_patterns=["ai"], seed=s), 16)
               for s, n in enumerate((48, 32))]
    group = StackedLoaderGroup(loaders)
    assert len(group) == 3
    steps = list(group)
    assert float(steps[-1]["sample_mask"][1].sum()) == 0.0
    assert float(steps[-1]["sample_mask"][0].sum()) > 0.0
    assert all(s["labels"].shape == (2, 16) for s in steps)


def test_empty_fold_raises_clear_error():
    class Empty:
        def __len__(self):
            return 0

        def __iter__(self):
            return iter(())

    class One:
        def __len__(self):
            return 1

        def __iter__(self):
            yield {"labels": np.zeros(4, np.int32)}

    with pytest.raises(ValueError, match="stacked run 1"):
        list(StackedLoaderGroup([One(), Empty()]))


# -- the route, as mmtpu's tests/test_stacked.py ----------------------------------


class _Recorder:
    def __init__(self):
        self.calls = []

    def __call__(self, name):
        def fn(*args, **kw):
            self.calls.append((name, kw))
            return 0

        return fn


def _route_cfg(cv=3, dp=None, model_type="avmnist"):
    return SimpleNamespace(experiment=SimpleNamespace(cross_validation=cv, data_parallel=dp),
                           model=SimpleNamespace(model_type=model_type))


@pytest.mark.parametrize("case", ["dp", "resume", "engine", "custom_step"])
def test_route_stacked_folds(monkeypatch, case):
    rec = _Recorder()
    monkeypatch.setattr(train_multimodal, "main_cross_validation", rec("sequential"))
    monkeypatch.setattr(stacked_cv, "run", rec("stacked"))
    args = SimpleNamespace(stacked_folds=True, data_parallel=2 if case == "dp" else None,
                           resume=case == "resume")
    cfg = _route_cfg(model_type="mmin" if case == "custom_step" else "avmnist")
    assert train_multimodal.route(cfg, args, CPU, json_nesting="avmnist") == 0
    want = "stacked" if case == "engine" else "sequential"
    kw = {"json_nesting": "avmnist", **({} if want == "stacked" else {"mesh": None})}
    assert rec.calls == [(want, kw)]


@pytest.mark.parametrize("case", ["engine", "dp", "cv", "resume"])
def test_route_stacked_runs(monkeypatch, case):
    calls = []
    monkeypatch.setattr(stacked_cv, "run_repeat",
                        lambda args, device, json_nesting: calls.append(("stacked", json_nesting))
                        or 0)
    monkeypatch.setattr(train_multimodal, "sequential_runs",
                        lambda args, device, json_nesting="reference", mesh=None:
                        calls.append(("sequential", args.stacked_runs)) or 0)
    args = SimpleNamespace(stacked_runs=3, stacked_folds=False,
                           data_parallel=2 if case == "dp" else None, resume=case == "resume")
    cfg = _route_cfg(cv=2 if case == "cv" else 0)
    assert train_multimodal.route(cfg, args, CPU, json_nesting="avmnist") == 0
    assert calls == ([("stacked", "avmnist")] if case == "engine" else [("sequential", 3)])


def test_sequential_runs_derive_members_like_the_stacked_engine(monkeypatch):
    base = SimpleNamespace(run_id=3, stacked_runs=2, config="x.yaml")
    seen = []

    def fake_load(sub, mesh=None):
        seen.append((sub.run_id, sub.seed_offset, sub.stacked_runs))
        return _route_cfg(cv=0)

    monkeypatch.setattr(common, "load_config", fake_load)
    monkeypatch.setattr(train_multimodal, "route",
                        lambda cfg, sub, device, json_nesting, mesh=None: 0)
    assert train_multimodal.sequential_runs(base, CPU) == 0
    assert seen == [(3, 0, 0), (4, 1, 0)]


def test_finalize_config_applies_seed_offset(tmp_path):
    cfg = common.load_config(SimpleNamespace(
        config=str(REPO / "configs/avmnist/synthetic_runs.yaml"), run_id=1, seed=None,
        seed_offset=3))
    assert cfg.experiment.seed == 14


# -- the CLI, both packages ---------------------------------------------------------


def _dropout0(root: Path, name: str) -> Path:
    text = (REPO / "configs/avmnist" / name).read_text()
    assert "dropout: 0.1" in text
    dst = root / name
    dst.write_text(text.replace("dropout: 0.1", "dropout: 0.0"))
    return dst


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """mmtpu's --stacked-folds and --stacked-runs 2, then the port's stacked
    and sequential runs of both, every port member from mmtpu's initial
    weights for its seed."""
    mp = pytest.MonkeyPatch()
    inits = {}
    real_jax_init = jax_common.init_model

    def jax_spy(model, sample, seed):
        params, stats = real_jax_init(model, sample, seed)
        inits[int(seed)] = (jax.tree_util.tree_map(np.asarray, params),
                            jax.tree_util.tree_map(np.asarray, stats))
        return params, stats

    def port_init(model, seed, device):
        params, stats = inits[int(seed)]
        model.load_state_dict(from_jax_variables(params, stats or None, target=model),
                              strict=True)
        torch.manual_seed(int(seed))
        return model.to(device)

    root = tmp_path_factory.mktemp("stacked_cli")
    cfgs = {"cv": _dropout0(root, "synthetic_cv.yaml"),
            "runs": _dropout0(root, "synthetic_runs.yaml")}
    runs = {"mmtpu": [("cv", ["--stacked-folds"], "1"), ("runs", ["--stacked-runs", "2"], "1")],
            "mmtpu_torch": [("cv", ["--stacked-folds"], "1"), ("runs", ["--stacked-runs", "2"], "1"),
                            ("cv", [], "1"), ("runs", [], "1"), ("runs", ["--seed", "12"], "2")]}
    out = {}
    try:
        mp.setattr(jax_common, "init_model", jax_spy)
        mp.setattr(common, "init_model", port_init)
        for pkg, items in runs.items():
            for cfg, extra, run_id in items:
                tag = "stk" if extra[:1] in (["--stacked-folds"], ["--stacked-runs"]) else "seq"
                work = root / pkg / f"{cfg}_{tag}"
                work.mkdir(parents=True, exist_ok=True)
                code = run_cli_inproc(f"{pkg}.cli.train_multimodal", cfgs[cfg], run_id=run_id,
                                      extra=extra, cwd=work)
                assert code == 0, (pkg, cfg, extra)
                out[(pkg, cfg, tag)] = work / "experiments_output"
    finally:
        mp.undo()
    yield out
    shutil.rmtree(root, ignore_errors=True)


def _metrics(base: Path):
    return {p.relative_to(base).as_posix(): json.loads(p.read_text())
            for p in sorted(base.rglob("*.json")) if "/models/" not in p.as_posix()}


def _tree(base: Path):
    return sorted(p.relative_to(base).as_posix().replace(".ckpt", ".·").replace(".pth", ".·")
                  for p in base.rglob("*") if "/logs/" not in p.as_posix())


def _keys(obj):
    if isinstance(obj, dict):
        return {k: _keys(v) for k, v in sorted(obj.items())}
    if isinstance(obj, list):
        return [_keys(v) for v in obj]
    return "·"


def _close(a, b, rtol, path=""):
    """Every number of record a within rtol of b's (timings left out)."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            if k not in ("timing", "total_time", "avg_batch_time", "index"):
                _close(a[k], b[k], rtol, f"{path}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, rtol, f"{path}[{i}]")
    elif isinstance(a, float):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=1e-6, err_msg=path)
    else:
        assert a == b, path


def _epoch_records(base: Path):
    return {k: v for k, v in _metrics(base).items() if k.endswith("epoch_metrics.json")}


@pytest.mark.parametrize("cfg", ["cv", "runs"])
def test_stacked_cli_writes_mmtpus_files_and_keys(cli_runs, cfg):
    port, jax_out = cli_runs[("mmtpu_torch", cfg, "stk")], cli_runs[("mmtpu", cfg, "stk")]
    assert _tree(port) == _tree(jax_out)
    pm, jm = _metrics(port), _metrics(jax_out)
    assert pm.keys() == jm.keys()
    for name in pm:
        if not name.endswith(("model_info.json",)):
            assert _keys(pm[name]) == _keys(jm[name]), name


@pytest.mark.parametrize("cfg", ["cv", "runs"])
def test_stacked_cli_records_match_mmtpu(cli_runs, cfg):
    port, jax_out = cli_runs[("mmtpu_torch", cfg, "stk")], cli_runs[("mmtpu", cfg, "stk")]
    jm = _epoch_records(jax_out)
    for name, rec in _epoch_records(port).items():
        _close(rec, jm[name], 1e-4, name)
    if cfg == "cv":
        for split in ("train", "validation", "test"):
            name = f"Synthetic_CV/metrics/1/{split}_metrics_agg.json"
            _close(_metrics(port)[name], _metrics(jax_out)[name], 1e-4, name)


@pytest.mark.parametrize("cfg", ["cv", "runs"])
def test_stacked_cli_records_match_sequential_port_runs(cli_runs, cfg):
    stk, seq = cli_runs[("mmtpu_torch", cfg, "stk")], cli_runs[("mmtpu_torch", cfg, "seq")]
    sm = _epoch_records(seq)
    for name, rec in _epoch_records(stk).items():
        _close(rec, sm[name], 1e-4, name)
    stk_files = {n for n in _tree(stk) if "/models/" not in n}
    seq_files = {n for n in _tree(seq) if "/models/" not in n}
    assert stk_files == seq_files
    if cfg == "runs":  # the two members trained from different seeds
        a = json.loads((stk / "Synthetic_Runs/metrics/1/epoch_metrics.json").read_text())
        b = json.loads((stk / "Synthetic_Runs/metrics/2/epoch_metrics.json").read_text())
        assert a[0]["train"]["loss"] != b[0]["train"]["loss"]


# -- the kernels' vmap rules in stacked steps ---------------------------------------


def _count_calls(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(module, name, counted)
    return calls


def test_stacked_utt_fusion_step_folds_members_into_the_lstm_groups(monkeypatch):
    """Two UttFusion members, one stacked train step: both LSTMs of both
    members go through one `lstm` call of K·G = 4 groups (forward), and the
    step equals mmtpu's vmapped one."""
    from test_torch_port_utt_train import KEYS, TRAINING, _batch as utt_batch, _model
    from mmtpu.config.training import TrainingConfig as JaxTrainingConfig
    from mmtpu_torch.config.training import TrainingConfig

    batches = [utt_batch(20 + s, padded_from=6 if s else None) for s in range(2)]
    jm = _model(jax_build_module)
    sample = [jnp.asarray(batches[0][k][:2]) for k in KEYS]
    jcfg = JaxTrainingConfig.from_dict(TRAINING)
    jstates = [jax_common.make_state(jm, jm.init({"params": jax.random.PRNGKey(s)},
                                                 *sample)["params"], {}, jcfg)
               for s in range(2)]
    tx = jstates[0].tx
    jstates = [JaxTrainState.create(apply_fn=jm.apply, params=s.params, tx=tx, batch_stats={})
               for s in jstates]
    jtask = JaxTask(model=jm, loss_group=JaxLossGroup.from_dict(TRAINING["loss_functions"]),
                    input_keys=KEYS)
    stacked_j, jout = jax_stacked.make_stacked_train_step(jtask, donate=False)(
        jax_stacked.stack_states(jstates), jax_stacked.stack_batches(batches),
        jax_stacked.stacked_rngs(jax.random.PRNGKey(0), 2))

    pstates = []
    for js in jstates:
        pm = _model(build_module)
        pm.load_state_dict(from_jax_variables(jax.tree_util.tree_map(np.asarray, js.params),
                                              target=pm), strict=True)
        pstates.append(common.make_state(pm, TrainingConfig.from_dict(TRAINING)))
    ptask = ClassificationTask(model=pstates[0].model, loss_group=LossFunctionGroup.from_dict(
        TRAINING["loss_functions"]), input_keys=KEYS)
    folds = _count_calls(monkeypatch, ops_lstm, "fold_groups")
    applies = []
    real_apply = ops_lstm._LSTM.apply

    def spy_apply(groups, *args):
        applies.append(groups)
        return real_apply(groups, *args)

    monkeypatch.setattr(ops_lstm._LSTM, "apply", spy_apply)
    stacked = StackedModel(ptask, pstates)
    out = stacked.train_step(stack_batches(batches), CPU)
    assert len(folds) == 1 and 4 in applies
    np.testing.assert_allclose(out["loss"].numpy(), np.asarray(jout["loss"]), rtol=TOL)
    for k, js in enumerate(_unstack(stacked_j, 2)):
        want = from_jax_variables(jax.tree_util.tree_map(np.asarray, js.params),
                                  target=stacked.states[k].model)
        got = stacked.member_state(k).model.state_dict()
        for name, w in want.items():
            np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0, atol=TOL,
                                       err_msg=name)


def test_stacked_avmnist_eval_folds_members_into_one_fused_mlp_call(monkeypatch):
    """Two AVMNIST members (LeNet encoders, head 64→32→16→10), one stacked
    eval step: the head of both members is ONE member-axis `fused_mlp`
    call, and the losses and predictions are mmtpu's vmapped eval's."""
    from mmtpu_torch.models.avmnist import AVMNIST
    from mmtpu_torch.models.lenet import LeNetEncoder

    jm = jax_build_module("avmnist", audio_encoder=jax_build_module(
        "lenetencoder", in_channels=1, hidden_dim=32), image_encoder=jax_build_module(
        "lenetencoder", in_channels=1, hidden_dim=32), hidden_dim=32, dropout=0.0)
    g = np.random.default_rng(3)
    batches = []
    for s in range(2):
        labels = g.integers(0, 10, 12)
        batches.append({"audio": g.normal(size=(12, 32, 94, 1)).astype(np.float32),
                        "image": g.normal(size=(12, 28, 28, 1)).astype(np.float32),
                        "audio_mask": np.ones(12, np.float32), "image_mask": np.ones(12, np.float32),
                        "labels": labels, "sample_mask": np.ones(12, np.float32)})
    batches[1]["image_mask"][::3] = 0.0
    jstates = []
    for s in range(2):
        v = jm.init({"params": jax.random.PRNGKey(s)}, jnp.zeros((2, 32, 94, 1)),
                    jnp.zeros((2, 28, 28, 1)), train=False)
        jstates.append(v)
    tx, _ = jax_build_optimizer(JaxOptimizerConfig(name="Adam", default_kwargs={"lr": 1e-3}),
                                jstates[0]["params"])
    jstates = [JaxTrainState.create(apply_fn=jm.apply, params=v["params"], tx=tx,
                                    batch_stats=v.get("batch_stats", {})) for v in jstates]
    jtask = JaxTask(model=jm, loss_group=JaxLossGroup.from_dict(LOSS),
                    input_keys=("audio", "image"))
    jout = jax_stacked.make_stacked_eval_step(jtask)(jax_stacked.stack_states(jstates),
                                                      jax_stacked.stack_batches(batches))
    pstates = []
    for js in jstates:
        pm = AVMNIST(LeNetEncoder(1, 32), LeNetEncoder(1, 32), hidden_dim=32, dropout=0.0)
        pm.load_state_dict(from_jax_variables(
            jax.tree_util.tree_map(np.asarray, js.params),
            jax.tree_util.tree_map(np.asarray, js.batch_stats), target=pm), strict=True)
        opt, _ = build_optimizer(OptimizerConfig(name="Adam", default_kwargs={"lr": 1e-3}), pm)
        pstates.append(TrainState(model=pm, optimizer=opt))
    ptask = ClassificationTask(model=pstates[0].model, loss_group=LossFunctionGroup.from_dict(LOSS),
                               input_keys=("audio", "image"))
    calls = _count_calls(monkeypatch, ops_mlp, "fused_mlp_members")
    out = StackedModel(ptask, pstates).eval_step(stack_batches(batches), CPU)
    assert len(calls) == 1
    np.testing.assert_allclose(out["loss"].numpy(), np.asarray(jout["loss"]), rtol=TOL)
    np.testing.assert_array_equal(out["preds"].numpy(), np.asarray(jout["preds"]))
