"""The rank side of the data-parallel tests (`tests/test_torch_port_parallel*.py`).

Each function here runs in every rank that `mmtpu_torch.parallel.launch`
starts. A spawned rank imports the module of the function it runs, so this
module imports torch and `mmtpu_torch` only, never JAX or a test module:
the tests write the inputs (mmtpu's weights, the batches) to files, and the
ranks write what they computed beside them, one file per rank.
"""

from __future__ import annotations

import builtins
import contextlib
import importlib
import io
import json
import os
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from mmtpu_torch.parallel.mesh import get_default_mesh

CPU = torch.device("cpu")


# -- the library cases: run_cases(work, names) --------------------------------------


def bn_case(work: Path, mesh) -> dict:
    """models/norm.py's BatchNorm in train mode on this rank's rows of the
    global input `bn.npz` holds: full (no mask) and padded (its mask); the
    output, the running statistics and the gradients of sum(y·g), the
    weight's and bias's summed over the ranks as a train step sums them."""
    from mmtpu_torch.models.norm import BatchNorm, batch_mask

    data = np.load(work / "bn.npz")
    rows = mesh.rows(data["x"].shape[0])
    out = {}
    for variant in ("full", "padded"):
        bn = BatchNorm(data["x"].shape[1])
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(data["weight"]))
            bn.bias.copy_(torch.from_numpy(data["bias"]))
        x = torch.from_numpy(data["x"][rows]).requires_grad_()
        mask = torch.from_numpy(data["mask"][rows]) if variant == "padded" else None
        with batch_mask(mask), mesh:
            y = bn(x)
        (y * torch.from_numpy(data["g"][rows])).sum().backward()
        mesh.all_reduce_grads(bn.parameters())
        out[variant] = {"y": y.detach(), "x_grad": x.grad, "weight_grad": bn.weight.grad,
                        "bias_grad": bn.bias.grad, "running_mean": bn.running_mean.clone(),
                        "running_var": bn.running_var.clone()}
    return out


def steps_model(spec: dict):
    """The port's model of a `steps.pt` case, from mmtpu's weights."""
    from mmtpu_torch.config.spec import specs_from_dicts
    from mmtpu_torch.models import build_module

    model = build_module(spec["name"], **specs_from_dicts(spec["kwargs"]))
    model.load_state_dict(spec["state_dict"], strict=True)
    return model


def steps_case(work: Path, mesh) -> dict:
    """Three train steps through `make_train_step` on this rank's rows of
    each global batch of `steps.pt` (mmtpu's `tests/test_parallel.py`
    recipes); the final state and, per step, the global loss and the
    predictions gathered in global order."""
    from mmtpu_torch.config.optim import OptimizerConfig
    from mmtpu_torch.parallel.mesh import replicate
    from mmtpu_torch.train.losses import LossFunctionGroup
    from mmtpu_torch.train.optim import build_optimizer
    from mmtpu_torch.train.state import TrainState
    from mmtpu_torch.train.step import ClassificationTask, make_train_step

    out = {}
    for name, spec in torch.load(work / "steps.pt", weights_only=False).items():
        model = replicate(steps_model(spec), mesh) if mesh is not None else steps_model(spec)
        optimizer, _ = build_optimizer(OptimizerConfig(**spec["optimizer"]), model)
        state = TrainState(model=model, optimizer=optimizer, mesh=mesh)
        task = ClassificationTask(model=model, loss_group=LossFunctionGroup.from_dict(
            {"ce": {"loss_name": "cross_entropy", "weight": 1.0}}),
            input_keys=spec["input_keys"])
        step = make_train_step(task, state, CPU)
        losses, preds = [], []
        for batch in spec["batches"]:
            res = step(batch)
            loss, pred = float(res["loss"]), res["preds"].numpy()
            if mesh is not None:
                loss = float(sum(mesh.gather(loss)))
                pred = np.concatenate(mesh.gather(pred))
            losses.append(loss)
            preds.append(pred)
        out[name] = {"losses": losses, "preds": preds,
                     "state": {k: v.clone() for k, v in model.state_dict().items()}}
    return out


def loop(mode: str, state_dict: dict, mesh=None, train_batch: int = 32, epochs: int = 2):
    """mmtpu's `tests/test_device_loop.py::build_loop` recipe in the port
    (AVMNIST over two FcEncoders, 96 train and 32 validation samples,
    batch 32, Adam 1e-3), from mmtpu's initial weights; on a mesh with a
    model axis, its head sharded."""
    from mmtpu_torch.checkpoints.manager import CheckpointManager
    from mmtpu_torch.config.metrics import MetricConfig, MetricDef
    from mmtpu_torch.config.optim import OptimizerConfig
    from mmtpu_torch.data.avmnist import SyntheticAVMNIST
    from mmtpu_torch.data.loader import BatchLoader
    from mmtpu_torch.models.avmnist import AVMNIST
    from mmtpu_torch.models.fc import FcEncoder
    from mmtpu_torch.train.early_stopping import EarlyStopping
    from mmtpu_torch.train.loop import TrainLoop
    from mmtpu_torch.train.losses import LossFunctionGroup
    from mmtpu_torch.train.optim import build_optimizer
    from mmtpu_torch.train.recorder import MetricRecorder
    from mmtpu_torch.train.state import TrainState
    from mmtpu_torch.train.step import ClassificationTask

    ds_tr = SyntheticAVMNIST(split="train", num_samples=96, selected_patterns=["ai"], seed=1)
    ds_va = SyntheticAVMNIST(split="valid", num_samples=32,
                             selected_patterns=["ai", "a", "i"], seed=1)
    loaders = {"train": BatchLoader(ds_tr, train_batch, shuffle=True, seed=5),
               "validation": BatchLoader(ds_va, 32)}
    model = AVMNIST(FcEncoder(3008, [16], dropout=0.0), FcEncoder(784, [16], dropout=0.0),
                    hidden_dim=16, dropout=0.0)
    model.load_state_dict(state_dict, strict=True)
    if mesh is not None and mesh.model_size > 1:
        from mmtpu_torch.parallel.tensor import shard_module

        shard_module(model, mesh, AVMNIST.TENSOR_PARALLEL_RULE)
    optimizer, _ = build_optimizer(OptimizerConfig(name="Adam", default_kwargs={"lr": 1e-3}),
                                   model)
    task = ClassificationTask(model=model, loss_group=LossFunctionGroup.from_dict(
        {"ce": {"loss_name": "cross_entropy", "weight": 1.0}}), input_keys=("audio", "image"))
    mc = MetricConfig(metrics={"accuracy": MetricDef(function="sklearn.metrics.accuracy_score")},
                      groups={"classification": ["accuracy"]})
    return TrainLoop(task=task, state=TrainState(model=model, optimizer=optimizer),
                     loaders=loaders, recorder=MetricRecorder(mc),
                     checkpoint_manager=CheckpointManager(tempfile.mkdtemp()), device=CPU,
                     epochs=epochs, early_stopping=EarlyStopping(enabled=False),
                     device_resident=mode, eval_batch_factor=1, mesh=mesh)


def loop_case(work: Path, mesh) -> dict:
    """The loop resident and streaming on the mesh from `loop.pt`'s weights,
    two epochs each; the splits a train batch of 31 (not divisible by 2)
    leaves resident."""
    state_dict = torch.load(work / "loop.pt", weights_only=True)
    out = {}
    for mode in ("on", "off"):
        lp = loop(mode, state_dict, mesh)
        out[f"{mode}_resident"] = sorted(lp._resident)
        lp.run()
        out[mode] = lp.epoch_metrics
        out[f"{mode}_state"] = {k: v.clone() for k, v in lp.state.model.state_dict().items()}
    out["indivisible_resident"] = sorted(loop("on", state_dict, mesh, train_batch=31)._resident)
    return out


# -- the model axis: model_axis_case on a (2, 2) mesh, or in one process --------------

MODEL_AXIS_OPTIMIZERS = {
    # mmtpu's tests/test_parallel.py:157 (two SGD steps), __graft_entry__.py:261
    # (Adam with coupled L2), and a step whose global-norm clip binds
    "sgd": ({"name": "SGD", "default_kwargs": {"lr": 1e-2}}, None, 2),
    "adam": ({"name": "Adam", "default_kwargs": {"lr": 5e-4, "weight_decay": 1e-4}}, None, 2),
    "clip": ({"name": "SGD", "default_kwargs": {"lr": 1e-2}}, 0.05, 1),
}
MODEL_AXIS_DROPOUT, MODEL_AXIS_DROPOUT_SEED = 0.5, 11


def _gathered(mesh, value):
    """A step's per-rank output over the data group: losses summed, arrays
    joined in global order; the value itself in one process."""
    if mesh is None:
        return value
    parts = mesh.gather(value)
    return float(sum(parts)) if isinstance(value, float) else np.concatenate(parts)


def model_axis_case(work: Path, mesh) -> dict:
    """`model_axis.pt`'s conv AVMNIST (mmtpu's weights) with its head
    sharded over the model axis of `mesh` (whole in one process): per
    optimizer of MODEL_AXIS_OPTIMIZERS its steps' global losses and
    predictions, the gathered state and this rank's own; after the SGD
    steps the eval step's global predictions, the recorder's metrics, the
    kernel calls per eval step, a checkpoint every rank saves (who wrote)
    and reads back into its shards; a training forward's logits with
    dropout."""
    from mmtpu_torch.checkpoints.manager import CheckpointManager
    from mmtpu_torch.config.metrics import MetricConfig, MetricDef
    from mmtpu_torch.config.optim import OptimizerConfig
    from mmtpu_torch.models import avmnist
    from mmtpu_torch.parallel.tensor import gather_state_dict, shard_module
    from mmtpu_torch.train.losses import LossFunctionGroup
    from mmtpu_torch.train.optim import build_optimizer
    from mmtpu_torch.train.recorder import MetricRecorder
    from mmtpu_torch.train.state import TrainState
    from mmtpu_torch.train.step import ClassificationTask, make_eval_step, make_train_step

    data = torch.load(work / "model_axis.pt", weights_only=False)
    out = {}
    for name, (opt, clip, steps) in MODEL_AXIS_OPTIMIZERS.items():
        model = steps_model(data["spec"])
        if mesh is not None:
            shard_module(model, mesh, avmnist.AVMNIST.TENSOR_PARALLEL_RULE)
        optimizer, _ = build_optimizer(OptimizerConfig(**opt), model)
        state = TrainState(model=model, optimizer=optimizer, mesh=mesh, clip=clip)
        task = ClassificationTask(model=model, loss_group=LossFunctionGroup.from_dict(
            {"ce": {"loss_name": "cross_entropy", "weight": 1.0}}), input_keys=("audio", "image"))
        step = make_train_step(task, state, CPU)
        rec = {"losses": [], "preds": []}
        for _ in range(steps):
            res = step(data["batch"])
            rec["losses"].append(_gathered(mesh, float(res["loss"])))
            rec["preds"].append(_gathered(mesh, res["preds"].numpy()))
        rec["state"] = gather_state_dict(model)
        rec["local"] = {k: v.detach().clone() for k, v in model.state_dict().items()}
        out[name] = rec
        if name != "sgd":
            continue
        calls = []
        real = avmnist.fused_mlp
        avmnist.fused_mlp = lambda *a: calls.append(1) or real(*a)
        try:
            ev = make_eval_step(task, CPU, mesh)(data["batch"])
        finally:
            avmnist.fused_mlp = real
        recorder = MetricRecorder(MetricConfig(
            metrics={"accuracy": MetricDef(function="sklearn.metrics.accuracy_score")},
            groups={"classification": ["accuracy"]}))
        recorder.update_group_ids("classification", *(
            torch.from_numpy(_gathered(mesh, ev[k].numpy()))
            for k in ("preds", "labels", "pattern_id")), ["ai"], None)
        rec["eval"] = {"preds": _gathered(mesh, ev["preds"].numpy()),
                       "logits": _gathered(mesh, ev["logits"].numpy()),
                       "metrics": recorder.calculate_all_groups()["classification"],
                       "kernel_calls": len(calls)}
        saved = []
        real_save = torch.save
        def save(obj, f, *args, **kwargs):
            if isinstance(f, (str, Path)):  # not the gathers' in-memory pickles
                saved.append(str(f))
            return real_save(obj, f, *args, **kwargs)

        torch.save = save
        try:
            CheckpointManager(work / ("ckpt" if mesh is not None else "ckpt_single")
                              ).save_checkpoint(state, 1, 0.5)
        finally:
            torch.save = real_save
        if mesh is not None:
            mesh.barrier()
        with torch.no_grad():
            for p in model.parameters():
                p.zero_()
        CheckpointManager(work / ("ckpt" if mesh is not None else "ckpt_single")
                          ).load_checkpoint(state, "best")
        rec["saved"] = saved
        rec["restored"] = {k: v.detach().clone() for k, v in model.state_dict().items()}
    # a training forward with dropout, the encoders in eval mode: one mask
    # over the whole fusion activation, drawn after one seed on every rank
    model = steps_model(data["spec"])
    model.dropout.p = MODEL_AXIS_DROPOUT
    if mesh is not None:
        shard_module(model, mesh, avmnist.AVMNIST.TENSOR_PARALLEL_RULE)
    model.train()
    model.audio_encoder.eval()
    model.image_encoder.eval()
    torch.manual_seed(MODEL_AXIS_DROPOUT_SEED)
    with torch.no_grad():
        out["dropout"] = model(*(torch.from_numpy(data["batch"][k]) for k in ("audio", "image")))
    if mesh is not None:
        lp = loop("off", data["loop"], mesh)
        lp.run()
        out["loop"] = lp.epoch_metrics
    return out


LOSS_UNITS = ("mmd", "moments", "mi", "cmam")


@contextlib.contextmanager
def _float64_criteria():
    """The criteria keep float64 (they cast their inputs to float32, as
    mmtpu's do)."""
    from mmtpu_torch.train import losses

    cast = losses._as_float
    losses._as_float = lambda x: torch.as_tensor(x).double()
    try:
        yield
    finally:
        losses._as_float = cast


def loss_unit(data: dict, unit: str, variant: str, rows: slice, mesh=None):
    """One of C-MAM's loss units in float64 on `rows` of `data` (the global
    batch of `loss.pt`), under `mesh` where given: (value, gradient of the
    predictions' rows). `variant` "padded" masks all but the first 5 of 16
    rows (at N = 2 rank 1 holds none). The MI term takes `data["perm"]`; the
    full loss, every weight on, draws its permutation from a generator
    seeded 11 (rank 0's on a mesh)."""
    from mmtpu_torch.train import cmam_loss as C

    p = data["p"][rows].clone().requires_grad_()
    t, orig = data["t"][rows], data["orig"][rows]
    sm = data["mask"][rows] if variant == "padded" else None

    def critic(o, z):
        return ((o @ data["A"]) * z).sum(-1)

    with _float64_criteria(), mesh if mesh is not None else contextlib.nullcontext():
        if unit == "mmd":
            value = C.mmd_loss(p, t, 1.5, sample_mask=sm)
        elif unit == "moments":
            value = C.moment_matching_loss(p, t, 3, sample_mask=sm)
        elif unit == "mi":
            value = C.CMAMLoss(cosine_weight=0.0, mae_weight=0.0, mse_weight=0.0,
                               cls_weight=0.0, mi_weight=1.0)(
                p, t, originals=orig, mi_critic=critic, sample_mask=sm,
                perm=data["perm"])["mi_loss"]
        else:
            loss = C.CMAMLoss(cls_weight=0.5, mmd_weight=0.7, moment_weight=0.3,
                              cyclic_weight=0.2, mi_weight=0.4, mmd_sigma=2.0)
            value = loss(p, t, originals=orig, reconstructed=p,
                         forward_func=lambda r: r @ data["Bc"], cls_logits=p @ data["C"],
                         cls_labels=data["labels"][rows], mi_critic=critic,
                         generator=torch.Generator().manual_seed(11),
                         sample_mask=sm)["total_loss"]
    value.backward()
    return value.detach(), p.grad


def loss_case(work: Path, mesh) -> dict:
    """Every loss unit and variant on this rank's rows of `loss.pt`: this
    rank's share of the value and its rows' gradient."""
    data = torch.load(work / "loss.pt", weights_only=True)
    rows = mesh.rows(data["p"].shape[0])
    return {(unit, variant): loss_unit(data, unit, variant, rows, mesh)
            for unit in LOSS_UNITS for variant in ("full", "padded")}


CASES = {"bn": bn_case, "steps": steps_case, "loop": loop_case, "loss": loss_case,
         "model_axis": model_axis_case}


def run_cases(work: str, names) -> int:
    """Every case of `names` in this rank; its results to rank{r}.pt."""
    mesh = get_default_mesh()
    work = Path(work)
    results = {name: CASES[name](work, mesh) for name in names}
    torch.save(results, work / f"rank{mesh.rank}.pt")
    return 0


# -- the CLI cases ---------------------------------------------------------------------


def audited_main(module: str, argv, audit_dir: str) -> int:
    """`module.main(argv)` in this rank, with every file this process opens
    for writing (or `torch.save`s) listed in `<audit_dir>/writes_rank{r}.json`."""
    rank = get_default_mesh().rank
    written = []
    real_open, real_io_open = builtins.open, io.open

    def spy(opener):
        def opened(file, mode="r", *args, **kwargs):
            if any(c in str(mode) for c in "wax+"):
                written.append(str(file))
            return opener(file, mode, *args, **kwargs)
        return opened

    real_save = torch.save

    def save(obj, f, *args, **kwargs):  # opens its path in C++
        if isinstance(f, (str, os.PathLike)):
            written.append(str(f))
        return real_save(obj, f, *args, **kwargs)

    builtins.open, io.open, torch.save = spy(real_open), spy(real_io_open), save
    try:
        rc = importlib.import_module(module).main(list(argv))
    finally:
        builtins.open, io.open, torch.save = real_open, real_io_open, real_save
    Path(audit_dir, f"writes_rank{rank}.json").write_text(json.dumps(written))
    return rc


def no_dropout_main(module: str, argv) -> int:
    """`module.main(argv)` in this rank with every `GeneratorDropout` at
    p = 0: each rank draws its own masks, so the parity runs take none."""
    from mmtpu_torch.models.rng import GeneratorDropout

    real = GeneratorDropout.__init__

    def init(self, p, *args, **kwargs):
        real(self, 0.0, *args, **kwargs)

    GeneratorDropout.__init__ = init
    try:
        return importlib.import_module(module).main(list(argv))
    finally:
        GeneratorDropout.__init__ = real


def fail_on_rank(bad: int, module: str, argv) -> int:
    """Rank `bad` raises before it trains; the others run `module.main`."""
    if get_default_mesh().rank == bad:
        raise RuntimeError(f"rank {bad} fails on purpose")
    return importlib.import_module(module).main(list(argv))


def _spy_h5py(written: list):
    """List every HDF5 file h5py opens for writing (it opens them in C);
    returns the real `h5py.File` to put back, or None without h5py."""
    try:
        import h5py
    except ImportError:
        return None
    real = h5py.File

    class File(real):
        def __init__(self, name, mode="r", *args, **kwargs):
            if any(c in str(mode) for c in "wax+"):
                written.append(str(name))
            super().__init__(name, mode, *args, **kwargs)

    h5py.File = File
    return real


@contextlib.contextmanager
def probes(out: Path, tag: str, weights=None):
    """Inside the `with` body a training CLI runs with no dropout and ε = 0
    (each rank would draw its own), its models from `weights` (mmtpu's
    initial variables, in the order the driver builds its models) when
    given, and what it does recorded to `<out>/<tag>.pt`: every file opened
    for writing (or `torch.save`d), RedCore's schedule after each step and
    Self-MM's banks after the last step."""
    from mmtpu_torch.checkpoints import from_jax_variables
    from mmtpu_torch.cli import common
    from mmtpu_torch.models import rng
    from mmtpu_torch.train import redcore_step
    from mmtpu_torch.train.managers import ManagerState

    seen = {"writes": [], "sched": [], "banks": None}
    queue = list(weights or ())
    real = (builtins.open, io.open, torch.save, common.init_model, redcore_step.advance_schedule,
            ManagerState.update_centers, rng.GeneratorDropout.forward, rng.GeneratorNormal.forward)

    def spy(opener):
        def opened(file, mode="r", *args, **kwargs):
            if any(c in str(mode) for c in "wax+"):
                seen["writes"].append(str(file))
            return opener(file, mode, *args, **kwargs)
        return opened

    def save(obj, f, *args, **kwargs):  # opens its path in C++
        if isinstance(f, (str, os.PathLike)):
            seen["writes"].append(str(f))
        return real[2](obj, f, *args, **kwargs)

    h5_file = _spy_h5py(seen["writes"])

    def init_model(model, seed, device):
        if not queue:
            return real[3](model, seed, device)
        v = queue.pop(0)
        model.load_state_dict(from_jax_variables(v["params"], v.get("batch_stats") or None,
                                                 target=model), strict=True)
        torch.manual_seed(int(seed))
        return model.to(device)

    def advance(task, sched, mses):
        new = real[4](task, sched, mses)
        seen["sched"].append({k: getattr(new, k).clone()
                              for k in ("beta", "loss_ema", "eta", "iter_count")})
        return new

    def centers(self, *args, **kwargs):
        out = real[5](self, *args, **kwargs)
        seen["banks"] = {f"{kind}/{m}": v.clone() for kind in
                         ("features", "labels", "centers_pos", "centers_neg")
                         for m, v in getattr(self, kind).items()}
        return out

    builtins.open, io.open, torch.save = spy(real[0]), spy(real[1]), save
    common.init_model, redcore_step.advance_schedule = init_model, advance
    ManagerState.update_centers = centers
    rng.GeneratorDropout.forward = lambda self, x: x
    rng.GeneratorNormal.forward = lambda self, like: torch.zeros_like(like)
    try:
        yield
    finally:
        (builtins.open, io.open, torch.save, common.init_model, redcore_step.advance_schedule,
         ManagerState.update_centers, rng.GeneratorDropout.forward,
         rng.GeneratorNormal.forward) = real
        if h5_file is not None:
            sys.modules["h5py"].File = h5_file
        torch.save(seen, Path(out) / f"{tag}.pt")


def probed_main(module: str, argv, out: str, weights_file=None) -> int:
    """`module.main(argv)` under `probes`, in a rank (`rank{r}.pt`) or in
    one process (`single.pt`); `weights_file` holds the list of mmtpu's
    initial variables."""
    mesh = get_default_mesh()
    if mesh is not None:  # tiny models: two threads a rank leave the suite's other workers room
        torch.set_num_threads(2)
    weights = torch.load(weights_file, weights_only=False) if weights_file else None
    with probes(Path(out), "single" if mesh is None else f"rank{mesh.rank}", weights):
        return importlib.import_module(module).main(list(argv))


# -- the multi-process mesh: `python -c` workers of tests/test_torch_port_multihost.py --


def multihost_audited(job: dict) -> int:
    """`parallel.multihost.rank_job` with this rank's `torch.save` paths and
    its calls of the head's kernel wrapper listed in
    `<out>/audit_procs{P}_rank{r}.json`."""
    from mmtpu_torch.models import avmnist
    from mmtpu_torch.parallel import multihost

    rank = get_default_mesh().rank
    saved, calls = [], []
    real_save, real_mlp = torch.save, avmnist.fused_mlp

    def save(obj, f, *args, **kwargs):
        if isinstance(f, (str, os.PathLike)):
            saved.append(str(f))
        return real_save(obj, f, *args, **kwargs)

    torch.save = save
    avmnist.fused_mlp = lambda *a: calls.append(1) or real_mlp(*a)
    try:
        rc = multihost.rank_job(job)
    finally:
        torch.save, avmnist.fused_mlp = real_save, real_mlp
    Path(job["out"], f"audit_procs{job['procs']}_rank{rank}.json").write_text(
        json.dumps({"saved": saved, "fused_mlp_calls": len(calls)}))
    return rc


def multihost_failing(job: dict) -> int:
    """Global rank 2 raises; every other rank waits in a barrier that rank
    never reaches."""
    mesh = get_default_mesh()
    if mesh.rank == 2:
        raise RuntimeError("rank 2 fails on purpose")
    mesh.barrier()
    return 0


def multihost_main(argv, job: str = "multihost_audited") -> int:
    """One worker of `parallel.multihost` running `job` of this module."""
    from mmtpu_torch.parallel import multihost

    return multihost.main(list(argv), job=globals()[job])
