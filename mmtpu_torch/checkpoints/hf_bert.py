"""Reader of a Hugging Face BERT directory (counterpart of mmtpu's
`FlaxBertModel.from_pretrained(path, from_pt=True)`), with no
`transformers` or `safetensors` package.

`config.json` sets the architecture (`models/bert_text.BertConfig`). The
weights come from the first file present in flax's order of preference:
`flax_model.msgpack` (through the port's msgpack decoder and
`from_jax_variables`), `model.safetensors` (read here: an 8-byte
little-endian header length, a JSON header of dtype, shape and byte
offsets, then the raw little-endian tensors), `pytorch_model.bin`
(`torch.load(weights_only=True)`). So a directory with both a
`.safetensors` and a `.bin` file gives the `.safetensors` weights, as
flax's reader takes them. A sharded checkpoint (`*.index.json`) raises.

Keys are normalised to the port's `BertModel`: a `bert.` prefix dropped,
the old `gamma`/`beta` LayerNorm names renamed, and the task heads
(`cls.*`) and the `embeddings.position_ids` buffer left out. Every tensor
is float32.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Union

import torch

CONFIG = "config.json"
FLAX = "flax_model.msgpack"
SAFETENSORS = "model.safetensors"
PYTORCH = "pytorch_model.bin"
SHARD_INDEXES = ("flax_model.msgpack.index.json", "model.safetensors.index.json",
                 "pytorch_model.bin.index.json")

_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}
_MODULES = ("embeddings.", "encoder.", "pooler.")


def read_safetensors(path: Union[str, Path]) -> Dict[str, torch.Tensor]:
    """Every tensor of a `.safetensors` file, as a CPU tensor of its dtype."""
    data = bytearray(Path(path).read_bytes())
    if len(data) < 8:
        raise ValueError(f"{path}: not a safetensors file (too short)")
    n = int.from_bytes(data[:8], "little")
    header = json.loads(bytes(data[8:8 + n]).decode("utf-8"))
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{path}: tensor {name} has unsupported dtype {info['dtype']}")
        dtype = _ST_DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        shape = [int(s) for s in info["shape"]]
        count = (end - begin) // torch.empty((), dtype=dtype).element_size()
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        flat = torch.frombuffer(data, dtype=dtype, count=count, offset=base + begin)
        out[name] = flat.reshape(shape).clone()
    return out


def normalise_keys(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Torch BERT keys → the port's `BertModel` keys, float32."""
    out = {}
    for key, value in state.items():
        if key.startswith("bert."):
            key = key[len("bert."):]
        if not key.startswith(_MODULES) or key == "embeddings.position_ids":
            continue
        key = key.replace("LayerNorm.gamma", "LayerNorm.weight").replace(
            "LayerNorm.beta", "LayerNorm.bias")
        out[key] = value.detach().to(torch.float32)
    return out


def _read_flax(path: Path) -> Dict[str, torch.Tensor]:
    from mmtpu_torch.checkpoints.interop import from_jax_variables
    from mmtpu_torch.checkpoints.msgpack import read_ckpt

    tree = read_ckpt(path)
    tree = tree.get("params", tree)
    return dict(from_jax_variables(tree))


def read_bert_dir(path: Union[str, Path]):
    """(BertConfig, state dict) of a Hugging Face BERT directory."""
    from mmtpu_torch.models.bert_text import BertConfig

    path = Path(path)
    if not (path / CONFIG).is_file():
        raise FileNotFoundError(f"BERT directory {path} has no {CONFIG}")
    cfg = BertConfig.from_json(path / CONFIG)
    if (path / FLAX).is_file():
        state = _read_flax(path / FLAX)
    elif (path / SAFETENSORS).is_file():
        state = read_safetensors(path / SAFETENSORS)
    elif (path / PYTORCH).is_file():
        state = torch.load(path / PYTORCH, map_location="cpu", weights_only=True)
    else:
        sharded = [name for name in SHARD_INDEXES if (path / name).is_file()]
        if sharded:
            raise NotImplementedError(
                f"BERT directory {path} holds a sharded checkpoint ({sharded[0]}); "
                "only single-file checkpoints are read")
        raise FileNotFoundError(f"BERT directory {path} has none of {FLAX}, {SAFETENSORS}, "
                                f"{PYTORCH}")
    return cfg, normalise_keys(state)

