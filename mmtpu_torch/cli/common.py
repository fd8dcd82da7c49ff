"""Shared assembly for the port's entry points (counterpart of
`mmtpu/cli/common.py`): device choice, precision, config loading, model
building, checkpoint paths, and for the training CLIs the flag surface,
pretrained-encoder loading, the optimizer's encoder groups, and the
state / scheduler / early-stopping / recorder / checkpoint builders."""

from __future__ import annotations

import argparse
import logging
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from mmtpu_torch.config import StandardMultimodalConfig
from mmtpu_torch.modalities import Modality

logger = logging.getLogger(__name__)


def resolve_device(cpu: bool = False) -> torch.device:
    """`cuda` unless the caller asks for the CPU. Never falls back: without
    a GPU and without `cpu=True` this raises."""
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


def load_config(args) -> StandardMultimodalConfig:
    """Load --config, then apply --seed, --epochs, --dry-run, the precision
    and the output dirs."""
    cfg = StandardMultimodalConfig.load(args.config, run_id=args.run_id)
    if getattr(args, "seed", None) is not None:
        cfg.experiment.seed = args.seed
    if getattr(args, "epochs", None) is not None:
        cfg.training.epochs = int(args.epochs)
    if getattr(args, "dry_run", False):
        cfg.experiment.dry_run = True
    print(apply_precision(cfg), flush=True)
    cfg.logging.create_directories()
    return cfg


def standard_arg_parser(description: str) -> argparse.ArgumentParser:
    """The training CLIs' flags (the ones of mmtpu's that the port has)."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--config", required=True,
                   help="Path to a YAML config, or its plain-dict form as .json")
    p.add_argument("--run_id", type=int, default=1)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--dry-run", "--dry_run", dest="dry_run", action="store_true",
                   help="Build config, data, model and state, then exit")
    p.add_argument("--skip-train", dest="skip_train", action="store_true")
    p.add_argument("--skip-test", dest="skip_test", action="store_true")
    p.add_argument("--epochs", type=int, default=None, metavar="N",
                   help="Override training.epochs")
    p.add_argument("--resume", action="store_true",
                   help="Continue an interrupted run from its rolling last.pth")
    p.add_argument("--cpu", action="store_true", help="Run on the CPU instead of CUDA")
    return p


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


ENCODER_KEYS = ("audio_encoder", "image_encoder", "text_encoder", "video_encoder")
_NET_LETTER = {"audio": "netA", "image": "netI", "text": "netT", "video": "netV"}


def load_pretrained_encoders(model: nn.Module, pretrained: Optional[Dict[str, str]],
                             logging_cfg) -> List[str]:
    """Fill each named encoder submodule from its handoff file (mmtpu
    `load_pretrained_encoders`): per modality the submodule is the first of
    net{A,I,T,V}, `{mod}_model`, `{mod}_encoder` the model has; the path is
    templated like the logging paths, and a `.ckpt` name resolves to its
    `.pth` sibling. The file is an encoder state_dict (parameters and
    BatchNorm statistics). Returns the modalities loaded."""
    from mmtpu_torch.checkpoints.interop import load_pth
    from mmtpu_torch.checkpoints.manager import resolve_checkpoint_path
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
        resolved = resolve_checkpoint_path(
            logging_cfg.format_path(format_path_with_env(str(path))))
        load_pth(children[attr], resolved)
        loaded.append(str(modality))
        print(f"loaded pretrained {modality} encoder from {resolved}", flush=True)
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


def make_recorder(cfg):
    from mmtpu_torch.train.recorder import MetricRecorder

    return MetricRecorder(cfg.metrics)


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
    "utt-fusion": _UTT_FUSION,
    "utt_fusion": _UTT_FUSION,
    "uttfusionmodel": _UTT_FUSION,
}


def modalities_for_model(model_type: str) -> List[Modality]:
    key = model_type.lower()
    if key not in _MODALITIES:
        raise ValueError(f"model type {model_type!r} is not ported to mmtpu_torch yet")
    return list(_MODALITIES[key])


def checkpoint_path(cfg: StandardMultimodalConfig, which: str) -> Path:
    """best | last | epoch_K → <model_output_path>/<which>.pth; anything
    with a '/' or a .pth suffix is an explicit path."""
    if "/" in str(which) or str(which).endswith(".pth"):
        return Path(which)
    return Path(cfg.logging.model_output_path) / f"{which}.pth"
