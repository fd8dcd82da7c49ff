"""Shared assembly for the port's entry points (counterpart of
`mmtpu/cli/common.py`): device choice, precision, config loading, model
building, checkpoint paths, and for the training CLIs the flag surface
(every flag of mmtpu's), the profiler session, the data-parallel mesh and
its ranks, the --stacked-runs member recipe, pretrained-encoder loading,
the optimizer's encoder groups, and the state / scheduler / early-stopping
/ recorder / checkpoint builders."""

from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from mmtpu_torch.config import StandardMultimodalConfig
from mmtpu_torch.modalities import Modality

logger = logging.getLogger(__name__)


def resolve_device(cpu: bool = False, mesh=None) -> torch.device:
    """`cuda` unless the caller asks for the CPU; in a data-parallel rank
    (`mesh`, from `rank_mesh`), the rank's device. Never falls back: without
    a GPU and without `cpu=True` this raises."""
    if mesh is not None:
        return mesh.device
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device visible: mmtpu_torch entry points run on the GPU "
            "unless asked for the CPU (--cpu / device='cpu')"
        )
    return torch.device("cuda")


# experiment.precision → (TF32 in cuDNN convolutions, float32 matmul precision)
_PRECISION = {
    "f32": (False, "highest"),
    "float32": (False, "highest"),
    "highest": (False, "highest"),
    "tf32": (True, "high"),
    "bf16": (True, "medium"),
    "bfloat16": (True, "medium"),
}


def apply_precision(cfg) -> str:
    """Map `experiment.precision` onto PyTorch's float32 switches, as mmtpu
    maps it onto `jax_default_matmul_precision`. Unset means full float32:
    cuDNN would otherwise run float32 convolutions in TF32 by default.
    Process-wide settings; returns a one-line description."""
    p = cfg.experiment.precision
    conv_tf32, matmul = _PRECISION[p.lower()] if p else (False, "highest")
    torch.backends.cudnn.allow_tf32 = conv_tf32
    torch.set_float32_matmul_precision(matmul)
    return (
        f"precision {p or 'unset'}: TF32 convolutions "
        f"{'on' if conv_tf32 else 'off'}, float32 matmul precision {matmul!r}"
    )


def finalize_config(cfg, args, mesh=None):
    """The post-load wiring every training entry point shares (mmtpu's
    `finalize_config`): --seed, a sweep member's seed offset, --dry-run,
    --epochs, --disable_monitoring, the precision, the output dirs and the
    run log `<log_path>/run_<run_id>.log`, which on a data-parallel `mesh`
    rank 0 alone writes."""
    if getattr(args, "seed", None) is not None:
        cfg.experiment.seed = args.seed
    # --stacked-runs member i trains with seed base + i (derive_member_args)
    offset = int(getattr(args, "seed_offset", 0) or 0)
    if offset:
        cfg.experiment.seed = int(cfg.experiment.seed) + offset
    if getattr(args, "dry_run", False):
        cfg.experiment.dry_run = True
    if getattr(args, "epochs", None) is not None:
        cfg.training.epochs = int(args.epochs)
    if getattr(args, "disable_monitoring", False):
        cfg.monitoring.enabled = False
    from mmtpu_torch.utils import configure_logger

    print(apply_precision(cfg), flush=True)
    cfg.logging.create_directories()
    configure_logger(cfg.logging.log_path if mesh is None or mesh.is_writer else None,
                     suffix=f"run_{args.run_id}")
    return cfg


def load_config(args, mesh=None) -> StandardMultimodalConfig:
    """Load --config (run_id templated into the paths) and finalize it."""
    return finalize_config(StandardMultimodalConfig.load(args.config, run_id=args.run_id), args,
                           mesh)


def standard_arg_parser(description: str) -> argparse.ArgumentParser:
    """The training CLIs' flags: every flag and alias of mmtpu's, and
    --cpu, each with mmtpu's `dest`, so an mmtpu command line parses."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--config", required=True,
                   help="Path to a YAML config, or its plain-dict form as .json")
    p.add_argument("--run_id", type=int, default=1)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--dry-run", "--dry_run", dest="dry_run", action="store_true",
                   help="Build config, data, model and state, then exit")
    p.add_argument("--skip-train", dest="skip_train", action="store_true")
    p.add_argument("--skip-test", dest="skip_test", action="store_true")
    p.add_argument("--disable_monitoring", "--disable-monitoring", dest="disable_monitoring",
                   action="store_true",
                   help="Set monitoring.enabled false: no <monitor_path>/monitor_data.h5")
    p.add_argument("--cpu", action="store_true", help="Run on the CPU instead of CUDA")
    p.add_argument("--data-parallel", "--data_parallel", dest="data_parallel", type=int,
                   default=None, metavar="N",
                   help="Overrides experiment.data_parallel: N > 1 trains on N devices, "
                        "one process per rank (NCCL; with --cpu, N processes over gloo), "
                        "every batch split over them, with the single-device run's "
                        "numbers; -1 takes every visible GPU; 0 and 1 run on one device")
    p.add_argument("--profile", action="store_true",
                   help="Trace the training phase with torch.profiler into "
                        "<log_path>/profile/trace.json (a Chrome trace)")
    p.add_argument("--eval-batch-factor", "--eval_batch_factor", dest="eval_batch_factor",
                   type=int, default=None, metavar="N",
                   help="Fuse N loader batches of the patterns x samples eval product "
                        "into each eval step on the device-resident path (default: grow "
                        "toward 1024 rows, at most 8x); the losses are reduced per "
                        "original batch, so the results do not change. No effect on a "
                        "split that streams")
    p.add_argument("--epochs", type=int, default=None, metavar="N",
                   help="Override training.epochs")
    p.add_argument("--resume", action="store_true",
                   help="Continue an interrupted run from its rolling last.pth")
    p.add_argument("--stacked-folds", "--stacked_folds", dest="stacked_folds",
                   action="store_true",
                   help="Cross-validation only: train all folds as one vmapped program; "
                        "with --resume or data_parallel > 1, and for MMIN, RedCore and "
                        "Self-MM, the folds run one after another, as in mmtpu")
    p.add_argument("--stacked-runs", "--stacked_runs", dest="stacked_runs", type=int,
                   default=0, metavar="K",
                   help="Train K repeat runs, run_id..run_id+K-1, member i seeded seed+i, "
                        "each with its own run_id-scoped outputs, as one vmapped program "
                        "(one after another on a CV config, with --resume or "
                        "data_parallel > 1, and for MMIN, RedCore and Self-MM)")
    return p


class ProfilerSession:
    """A `torch.profiler` trace around the training phase (mmtpu's
    `ProfilerSession` traces it with the JAX profiler): CPU activity, and
    CUDA activity when a GPU is visible, written as a Chrome trace to
    `<log_path>/profile/trace.json` on exit."""

    def __init__(self, enabled: bool, log_path: str) -> None:
        self.enabled = enabled
        self.path = Path(log_path) / "profile" / "trace.json"
        self._prof = None

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._prof = profile(activities=activities)
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            self._prof.__exit__(*exc)
            self._prof.export_chrome_trace(str(self.path))
            print(f"profiler trace: {self.path}", flush=True)
            self._prof = None
        return False


def resolve_mesh(cfg, args, device: torch.device):
    """experiment.data_parallel / --data-parallel → the mesh to launch, or
    None, by mmtpu's rules: unset, 0 and 1 run on `device` alone; -1 takes
    every visible GPU (one device on the CPU); N < -1 raises; on the GPU, N
    greater than the visible cards raises mmtpu's ValueError (on the CPU no
    card count limits N: each rank is a process); a dataset batch_size not
    divisible by N raises mmtpu's message."""
    from mmtpu_torch.parallel.mesh import MeshConfig, create_mesh

    dp = getattr(args, "data_parallel", None)
    if dp is None:
        dp = cfg.experiment.data_parallel
    if not dp:
        return None
    if dp < -1:
        raise ValueError(f"data_parallel={dp}: use -1 (all devices) or N >= 1")
    cards = torch.cuda.device_count() if device.type == "cuda" else None
    if dp == -1:
        dp = cards or 1
    if dp == 1:
        return None
    if cards is not None and dp > cards:
        raise ValueError(f"data_parallel={dp} but only {cards} devices visible")
    for name, ds_cfg in getattr(getattr(cfg, "data", None), "datasets", {}).items():
        bs = getattr(ds_cfg, "batch_size", None)
        if bs and bs % dp:
            raise ValueError(
                f"dataset {name!r} batch_size={bs} not divisible by "
                f"data_parallel={dp}"
            )
    devices = ([torch.device("cuda", i) for i in range(dp)] if cards is not None
               else [device] * dp)
    return create_mesh(MeshConfig(data_parallel=dp), devices=devices)


def rank_mesh():
    """This process's data-parallel mesh: a launched rank's (set by
    `parallel/launch.py`), or None. The one place the CLIs read it: their
    entry hands it on to `resolve_device`, `finalize_config`, the drivers
    and `TrainLoop`, whose steps publish it with `with mesh:`."""
    from mmtpu_torch.parallel.mesh import get_default_mesh

    return get_default_mesh()


def run_ranks(args, device: torch.device, module: str, argv=None,
              mesh=None) -> Optional[int]:
    """A training CLI's data-parallel entry: when the run asks for N > 1
    devices (`resolve_mesh`) and this process is not already a rank (its
    `mesh`), run `module.main(argv)` in N ranks (`parallel/launch.py`) and
    return their exit code; None when it trains in this process (a rank, or
    one device)."""
    if mesh is not None:
        return None
    cfg = StandardMultimodalConfig.load(args.config, run_id=args.run_id)
    mesh = resolve_mesh(cfg, args, device)
    if mesh is None:
        return None
    from mmtpu_torch.parallel.launch import run_cli

    print(f"data-parallel mesh: {mesh.world_size} ranks on "
          f"{', '.join(str(d) for d in mesh.devices)} over {mesh.backend}", flush=True)
    return run_cli(mesh, module, sys.argv[1:] if argv is None else argv)


def check_rank(cfg, args, device: torch.device, mesh) -> None:
    """A driver's guard: a run that asks for several devices trains only
    in the ranks its CLI's `main` starts, each with its `mesh`."""
    want = resolve_mesh(cfg, args, device) if mesh is None else None
    if want is not None:
        raise RuntimeError(
            f"data_parallel={want.world_size}: the ranks are started by the CLI's main "
            "(parallel/launch.py); this process is not one of them")


def seed_rank_streams(mesh, seed: int, generator: Optional[torch.Generator] = None) -> None:
    """A data-parallel rank's random streams (dropout): torch's generator and
    the run's `generator`, where there is one, seeded with the run's seed
    plus the rank, so the ranks' rows do not draw one mask pattern. (The
    weights come from rank 0's, `parallel.mesh.replicate`.)"""
    torch.manual_seed(int(seed) + mesh.rank)
    if generator is not None:
        generator.manual_seed(int(seed) + mesh.rank)


def derive_member_args(args, base_run: int, i: int) -> argparse.Namespace:
    """Member i of a --stacked-runs sweep (mmtpu's one recipe): run_id
    base + i, seed + i (finalize_config applies `seed_offset`), no further
    stacking."""
    sub = argparse.Namespace(**vars(args))
    sub.run_id = base_run + i
    sub.stacked_runs = 0
    sub.seed_offset = i
    return sub


def run_id_sweep(args, run_one) -> int:
    """--stacked-runs K as mmtpu's sequential sweep (the reference's
    run_n.sh loop): `run_one` once per derived member, stopping at the
    first that fails."""
    runs = int(getattr(args, "stacked_runs", 0) or 0)
    if runs <= 1:
        return run_one(args)
    base_run = int(args.run_id)
    for i in range(runs):
        sub = derive_member_args(args, base_run, i)
        print(f"run {sub.run_id} ({i + 1}/{runs})", flush=True)
        rc = run_one(sub)
        if rc != 0:
            return rc
    return 0


def build_model_from_config(model_cfg) -> torch.nn.Module:
    from mmtpu_torch.models.registry import build_module

    return build_module(model_cfg.model_type, **model_cfg.kwargs)


def init_model(model: nn.Module, seed: int, device: torch.device) -> nn.Module:
    """Seeded initial weights (flax's initialisers' distributions, drawn on
    the CPU so every device gets the same ones), moved to `device`; torch's
    generator, which dropout draws from, seeded with the same seed."""
    from mmtpu_torch.models import seeded_init

    torch.manual_seed(int(seed))
    return seeded_init(model, seed).to(device)


def use_run_generator(model: nn.Module, seed: int,
                      device: torch.device) -> Optional[torch.Generator]:
    """The run's generator, seeded with the run's seed, for every module of
    `model` that draws from one (`models/rng.py`); None when none does."""
    from mmtpu_torch.models.rng import draws, use_generator

    if not draws(model):
        return None
    generator = torch.Generator(device=device).manual_seed(int(seed))
    use_generator(model, generator)
    return generator


ENCODER_KEYS = ("audio_encoder", "image_encoder", "text_encoder", "video_encoder")
_NET_LETTER = {"audio": "netA", "image": "netI", "text": "netT", "video": "netV"}


def load_pretrained_encoders(model: nn.Module, pretrained: Optional[Dict[str, str]],
                             logging_cfg) -> List[str]:
    """Fill each named encoder submodule from its file (mmtpu
    `load_pretrained_encoders`): per modality the submodule is the first of
    net{A,I,T,V}, `{mod}_model`, `{mod}_encoder` the model has; the path is
    templated like the logging paths. The file is the port's handoff (an
    encoder state_dict), a reference `.pth` or an mmtpu `.ckpt`, resolved
    and read by `checkpoints.manager.load_encoder_checkpoint`; tensors it
    has no source for keep their initial values, as in mmtpu, and are
    printed. Returns the modalities loaded."""
    from mmtpu_torch.checkpoints.manager import load_encoder_checkpoint
    from mmtpu_torch.utils import format_path_with_env

    loaded = []
    children = dict(model.named_children())
    for modality, path in (pretrained or {}).items():
        candidates = [_NET_LETTER.get(str(modality).lower()), f"{modality}_model",
                      f"{modality}_encoder"]
        attr = next((c for c in candidates if c and c in children), None)
        if attr is None:
            logger.warning(f"model has no encoder submodule for {modality!r} "
                           f"(tried {candidates}); skipping")
            continue
        report = load_encoder_checkpoint(
            logging_cfg.format_path(format_path_with_env(str(path))), children[attr])
        loaded.append(str(modality))
        print(f"loaded pretrained {modality} encoder from {report.path} ({report.format})",
              flush=True)
        if report.fallback:
            print(f"pretrained {modality} encoder: filled by shape from {report.path}: "
                  f"{report.fallback}", flush=True)
        if report.kept:
            print(f"pretrained {modality} encoder: no source in {report.path} for "
                  f"{report.kept}; kept their initial values", flush=True)
    return loaded


def encoder_param_groups(training, model: nn.Module) -> List[Tuple[str, Dict[str, Any]]]:
    """encoder_optimizer + modality_specific_params → (regex, kwargs) groups,
    one per `*_encoder` submodule, matched against mmtpu paths (`^attr/`)."""
    enc_kwargs = (dict(training.encoder_optimizer.default_kwargs)
                  if training.encoder_optimizer else None)
    specific = training.modality_specific_params or {}
    groups = []
    for attr, _ in model.named_children():
        if not attr.endswith("_encoder"):
            continue
        kwargs = dict(enc_kwargs) if enc_kwargs else None
        if attr in specific:
            kwargs = {**(kwargs or {}), **specific[attr]}
        if kwargs:
            groups.append((f"^{attr}/", kwargs))
    return groups


def make_state(model: nn.Module, training, clip: Optional[float] = None):
    from mmtpu_torch.train.optim import build_optimizer
    from mmtpu_torch.train.state import TrainState

    optimizer, report = build_optimizer(training.optimizer, model,
                                        extra_groups=encoder_param_groups(training, model))
    for name, kw in report.items():
        logger.info(f"optimizer group {name}: {kw}")
    return TrainState(model=model, optimizer=optimizer, clip=clip)


def make_lr_controller(training):
    from mmtpu_torch.train.optim import LRController

    if not training.scheduler:
        return None
    base_lr = float(training.optimizer.default_kwargs.get("lr", 1e-3))
    return LRController(training.scheduler, training.scheduler_args, base_lr)


def make_early_stopping(cfg):
    from mmtpu_torch.train.early_stopping import EarlyStopping, mode_for_metric

    return EarlyStopping(patience=cfg.training.early_stopping_patience,
                         min_delta=cfg.training.early_stopping_min_delta,
                         mode=mode_for_metric(cfg.logging.save_metric),
                         enabled=cfg.training.early_stopping)


def make_recorder(cfg, mesh=None):
    """The metric recorder; on a data-parallel mesh only rank 0's writes
    TensorBoard."""
    from mmtpu_torch.train.recorder import MetricRecorder

    writes = mesh is None or mesh.is_writer
    return MetricRecorder(cfg.metrics,
                          tensorboard_path=cfg.logging.tensorboard_path if writes else None,
                          tb_record_only=cfg.logging.tb_record_only)


def make_monitor(cfg, resume: bool = False, mesh=None):
    """The HDF5 experiment monitor when `monitoring.enabled` and
    `logging.monitor_path` are both set, else None (mmtpu's `make_monitor`).
    `resume` appends to the previous run's `monitor_data.h5` instead of
    truncating it. On a data-parallel `mesh` every rank keeps the cadence
    and rank 0 alone opens the file. Without h5py this raises, before the
    first step."""
    if not cfg.monitoring.enabled or not cfg.logging.monitor_path:
        return None
    from mmtpu_torch.monitor import ExperimentMonitor

    return ExperimentMonitor(cfg.monitoring, cfg.logging.monitor_path, resume=resume,
                             writes=mesh is None or mesh.is_writer)


def make_checkpoint_manager(cfg):
    from mmtpu_torch.checkpoints.manager import CheckpointManager

    return CheckpointManager(cfg.logging.model_output_path, save_metric=cfg.logging.save_metric)


def build_all_loaders(cfg, is_train: bool = True, is_test: bool = True) -> Dict[str, Any]:
    """One loader per configured split; train and validation only when
    training, test only when testing (mmtpu's `build_all_loaders`)."""
    loaders = {}
    for split in cfg.data.datasets:
        if split in ("train", "trn", "validation") and not is_train:
            continue
        if split == "test" and not is_test:
            continue
        loaders[split] = cfg.data.build_loader(split, seed=cfg.experiment.seed)
    return loaders


def infer_monomodal_modality(cfg) -> Modality:
    """The modality a monomodal run trains: an encoder key in the model
    kwargs, else the experiment name."""
    for key in ENCODER_KEYS:
        if key in cfg.model.kwargs:
            return Modality(key.split("_")[0])
    name = cfg.experiment.name.lower()
    for mod in ("audio", "image", "text", "video"):
        if mod in name:
            return Modality(mod)
    raise ValueError("cannot infer monomodal modality from config")


def infer_num_classes(cfg) -> int:
    n = cfg.model.kwargs.get("num_classes")
    if n:
        return int(n)
    name = (cfg.experiment.name + " " + cfg.model.name).lower()
    if "mmimdb" in name or "imdb" in name:
        return 23
    if "mosi" in name or "mosei" in name:
        return 3
    return 10  # avmnist


_UTT_FUSION = [Modality.AUDIO, Modality.VIDEO, Modality.TEXT]
_MODALITIES = {
    "avmnist": [Modality.AUDIO, Modality.IMAGE],
    "kineticssounds": [Modality.AUDIO, Modality.VIDEO],
    "mmimdb": [Modality.IMAGE, Modality.TEXT],
    "utt-fusion": _UTT_FUSION,
    "utt_fusion": _UTT_FUSION,
    "uttfusionmodel": _UTT_FUSION,
}


def modalities_for_model(model_type: str) -> List[Modality]:
    """mmtpu's `modalities_for_model` (mmtpu/cli/train_multimodal.py) for the
    model types that train through the generic step, with mmtpu's error for
    every other one."""
    key = model_type.lower()
    if key not in _MODALITIES:
        raise ValueError(f"Unknown model type: {model_type}")
    return list(_MODALITIES[key])


def checkpoint_path(cfg: StandardMultimodalConfig, which: str) -> Path:
    """best | last | epoch_K → <model_output_path>/<which>.pth; anything
    with a '/' or a .pth or .ckpt suffix is an explicit path."""
    if "/" in str(which) or str(which).endswith((".pth", ".ckpt")):
        return Path(which)
    return Path(cfg.logging.model_output_path) / f"{which}.pth"
