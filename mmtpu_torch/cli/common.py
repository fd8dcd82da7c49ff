"""Shared assembly for the port's entry points (counterpart of the parts of
`mmtpu/cli/common.py` the serving path needs): device choice, precision,
config loading, model building, checkpoint paths."""

from __future__ import annotations

from pathlib import Path
from typing import List

import torch

from mmtpu_torch.config import StandardMultimodalConfig
from mmtpu_torch.modalities import Modality


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
    """Load --config, then apply --seed, the precision and the output dirs."""
    cfg = StandardMultimodalConfig.load(args.config, run_id=args.run_id)
    if getattr(args, "seed", None) is not None:
        cfg.experiment.seed = args.seed
    print(apply_precision(cfg), flush=True)
    cfg.logging.create_directories()
    return cfg


def build_model_from_config(model_cfg) -> torch.nn.Module:
    from mmtpu_torch.models.registry import build_module

    return build_module(model_cfg.model_type, **model_cfg.kwargs)


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
