"""BERT text encoder (counterpart of mmtpu/models/bert_text.py).

The port's own BERT, written as `nn.Module`s: what `FlaxBertModel`
computes, under the torch `BertModel`'s module and state-dict names
(`embeddings.word_embeddings.weight`, `encoder.layer.{i}.attention.self.
query.weight`, ...), so a Hugging Face torch checkpoint loads by name:

- word, position (`arange(T)`) and token-type embeddings, summed in flax's
  order (words + token types + positions), LayerNorm, dropout;
- per layer: Q/K/V, softmax(q/√d · kᵀ + bias)·v over the heads, output
  dense, dropout, residual, LayerNorm; intermediate dense with BERT's
  `gelu`, the exact erf form (a config naming another activation raises);
  output dense, dropout, residual, LayerNorm;
- the output is `last_hidden_state`, (B, T, hidden). The pooler's
  parameters are carried and loaded; it is not on the encoder's path.

Flax's details, kept: a masked key gets `finfo(float32).min` added to its
score (not -inf, not a boolean mask), so a row whose mask is all zero
attends uniformly instead of giving NaN; the attention dropout is flax's
`broadcast_dropout=True`, one (T, T) keep-mask shared by the batch and the
heads; every LayerNorm takes flax's fast variance E[x²] − E[x]² (clipped
at 0) with epsilon `layer_norm_eps` (1e-12). Dropouts draw from the run's
generator (`models/rng.py`).

`BertTextEncoder` takes mmtpu's (B, 3, T) float rows (ids, attention mask,
segment ids, cast to integers). With `use_finetune: false` (the default)
BERT runs under `torch.no_grad()` and in eval mode (its dropouts off) even
while the model trains; its parameters stay in the model, so the optimizer
still holds them with zero gradients, as mmtpu holds them in `params`
behind `stop_gradient`. With `use_finetune: true` it trains with its
dropouts on. An existing `pretrained_path` (environment variables
expanded) is read as a Hugging Face directory by
`checkpoints/hf_bert.py`, its `config.json` setting the architecture; a
path that does not exist warns with mmtpu's "RANDOMLY INITIALIZED" message
and, as an empty path does silently, builds BERT-base's defaults with the
config's three sizes (vocab 30522, 512 positions, 2 token types,
intermediate 4 × hidden, dropouts 0.1), drawn as flax's BERT draws them:
normal(0, 0.02) embeddings and kernels, zero biases, LayerNorm 1 and 0.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
from pathlib import Path
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from mmtpu_torch.models.rng import GeneratorDropout

logger = logging.getLogger(__name__)



@dataclasses.dataclass
class BertConfig:
    """The fields of a Hugging Face `BertConfig` that the model reads, at
    BERT-base's defaults."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12

    def __post_init__(self) -> None:
        if self.hidden_act != "gelu":  # BERT's exact erf GELU, flax's `gelu`
            raise ValueError(f"BERT hidden_act {self.hidden_act!r} is not supported "
                             "(only 'gelu')")
        if self.hidden_size % self.num_attention_heads:
            raise ValueError(f"hidden_size {self.hidden_size} is not a multiple of "
                             f"{self.num_attention_heads} heads")

    @classmethod
    def from_json(cls, path) -> "BertConfig":
        """A `config.json`: the known fields, the others ignored."""
        raw: Dict[str, Any] = json.loads(Path(path).read_text())
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in raw.items() if k in names})


class FlaxLayerNorm(nn.LayerNorm):
    """LayerNorm over the last axis as flax computes it: the variance as
    E[x²] − E[x]² clipped at 0, y = (x − mean)·(rsqrt(var + eps)·weight)
    + bias."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=-1, keepdim=True)
        var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


def _linear(d_in: int, d_out: int, std: float) -> nn.Linear:
    layer = nn.Linear(d_in, d_out)
    layer.init_std = std  # seeded_init draws it from normal(0, std)
    return layer


def _embedding(n: int, d: int, std: float) -> nn.Embedding:
    layer = nn.Embedding(n, d)
    layer.init_std = std
    return layer


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig) -> None:
        super().__init__()
        std = cfg.initializer_range
        self.word_embeddings = _embedding(cfg.vocab_size, cfg.hidden_size, std)
        self.position_embeddings = _embedding(cfg.max_position_embeddings, cfg.hidden_size, std)
        self.token_type_embeddings = _embedding(cfg.type_vocab_size, cfg.hidden_size, std)
        self.LayerNorm = FlaxLayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.dropout = GeneratorDropout(cfg.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids) -> torch.Tensor:
        positions = torch.arange(input_ids.shape[1], device=input_ids.device)
        hidden = (self.word_embeddings(input_ids) + self.token_type_embeddings(token_type_ids)
                  + self.position_embeddings(positions)[None])
        return self.dropout(self.LayerNorm(hidden))


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig) -> None:
        super().__init__()
        self.heads = cfg.num_attention_heads
        self.head_dim = cfg.hidden_size // cfg.num_attention_heads
        std = cfg.initializer_range
        self.query = _linear(cfg.hidden_size, cfg.hidden_size, std)
        self.key = _linear(cfg.hidden_size, cfg.hidden_size, std)
        self.value = _linear(cfg.hidden_size, cfg.hidden_size, std)
        self.dropout = GeneratorDropout(cfg.attention_probs_dropout_prob, broadcast_dims=(0, 1))

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        B, T, _ = x.shape

        def heads(t: torch.Tensor) -> torch.Tensor:  # (B, T, d) → (B, heads, T, head_dim)
            return t.reshape(B, T, self.heads, self.head_dim).transpose(1, 2)

        q = heads(self.query(x)) / math.sqrt(self.head_dim)
        k, v = heads(self.key(x)), heads(self.value(x))
        weights = self.dropout(torch.softmax(q @ k.transpose(-1, -2) + bias, dim=-1))
        return (weights @ v).transpose(1, 2).reshape(B, T, -1)


class BertSelfOutput(nn.Module):
    def __init__(self, cfg: BertConfig) -> None:
        super().__init__()
        self.dense = _linear(cfg.hidden_size, cfg.hidden_size, cfg.initializer_range)
        self.LayerNorm = FlaxLayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.dropout = GeneratorDropout(cfg.hidden_dropout_prob)

    def forward(self, hidden: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        return self.LayerNorm(self.dropout(self.dense(hidden)) + residual)


class BertAttention(nn.Module):
    def __init__(self, cfg: BertConfig) -> None:
        super().__init__()
        self.self = BertSelfAttention(cfg)
        self.output = BertSelfOutput(cfg)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        return self.output(self.self(x, bias), x)


class BertIntermediate(nn.Module):
    def __init__(self, cfg: BertConfig) -> None:
        super().__init__()
        self.dense = _linear(cfg.hidden_size, cfg.intermediate_size, cfg.initializer_range)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(self.dense(x))


class BertOutput(nn.Module):
    def __init__(self, cfg: BertConfig) -> None:
        super().__init__()
        self.dense = _linear(cfg.intermediate_size, cfg.hidden_size, cfg.initializer_range)
        self.LayerNorm = FlaxLayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.dropout = GeneratorDropout(cfg.hidden_dropout_prob)

    def forward(self, hidden: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        return self.LayerNorm(self.dropout(self.dense(hidden)) + residual)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig) -> None:
        super().__init__()
        self.attention = BertAttention(cfg)
        self.intermediate = BertIntermediate(cfg)
        self.output = BertOutput(cfg)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        x = self.attention(x, bias)
        return self.output(self.intermediate(x), x)


class BertEncoder(nn.Module):
    def __init__(self, cfg: BertConfig) -> None:
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(cfg) for _ in range(cfg.num_hidden_layers))

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        for layer in self.layer:
            x = layer(x, bias)
        return x


class BertPooler(nn.Module):
    """tanh(dense([CLS])): carried with the weights, not on the path."""

    def __init__(self, cfg: BertConfig) -> None:
        super().__init__()
        self.dense = _linear(cfg.hidden_size, cfg.hidden_size, cfg.initializer_range)

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.dense(hidden[:, 0]))


class BertModel(nn.Module):
    def __init__(self, cfg: BertConfig) -> None:
        super().__init__()
        self.config = cfg
        self.embeddings = BertEmbeddings(cfg)
        self.encoder = BertEncoder(cfg)
        self.pooler = BertPooler(cfg)

    def forward(self, input_ids, attention_mask, token_type_ids) -> torch.Tensor:
        """(B, T) integer rows → last_hidden_state (B, T, hidden)."""
        x = self.embeddings(input_ids, token_type_ids)
        low = torch.finfo(torch.float32).min
        bias = torch.where(attention_mask > 0, 0.0, low).to(x.dtype)[:, None, None, :]
        return self.encoder(x, bias)


class BertTextEncoder(nn.Module):
    def __init__(self, language: str = "en", use_finetune: bool = False,
                 pretrained_path: str = "pretrained_model/bert_en", hidden_size: int = 768,
                 num_hidden_layers: int = 12, num_attention_heads: int = 12) -> None:
        super().__init__()
        if language not in ("en", "cn"):
            raise ValueError(f"BertTextEncoder language {language!r} not in ('en', 'cn')")
        self.language = language
        self.use_finetune = bool(use_finetune)
        self.pretrained_path = pretrained_path
        cfg, state = _bert_config_and_state(pretrained_path, hidden_size, num_hidden_layers,
                                            num_attention_heads)
        self.bert = BertModel(cfg)
        # the file's weights, applied again after a seeded initialisation
        self._pretrained: Optional[Dict[str, torch.Tensor]] = state
        self.restore_pretrained()
        self.train(self.training)

    def get_embedding_size(self) -> int:
        return self.bert.config.hidden_size

    @torch.no_grad()
    def restore_pretrained(self) -> None:
        """Copy the weights read at construction back into BERT (a no-op
        for a randomly initialised one); `seeded_init` calls it last."""
        if self._pretrained is not None:
            _load_bert_state(self.bert, self._pretrained, self.pretrained_path)

    def train(self, mode: bool = True) -> "BertTextEncoder":
        super().train(mode)
        self.bert.train(mode and self.use_finetune)  # frozen BERT: eval-mode forward
        return self

    def forward(self, text: torch.Tensor) -> torch.Tensor:
        ids, mask, types = (text[:, i, :].long() for i in range(3))
        if self.use_finetune:
            return self.bert(ids, mask, types)
        with torch.no_grad():
            return self.bert(ids, mask, types)


def _bert_config_and_state(pretrained_path, hidden_size: int, num_hidden_layers: int,
                           num_attention_heads: int):
    """mmtpu's `_build_bert`: (config, state dict) of an existing
    pretrained directory, else (BERT-base's defaults at the given sizes,
    None), warning when a named directory does not exist."""
    from mmtpu_torch.utils import format_path_with_env

    if pretrained_path:
        path = Path(format_path_with_env(str(pretrained_path)))
        if path.exists():
            from mmtpu_torch.checkpoints.hf_bert import read_bert_dir

            return read_bert_dir(path)
        msg = (f"BERT pretrained path {path} not found — Self-MM will train with a RANDOMLY "
               "INITIALIZED text encoder (the reference loads pretrained BERT weights here, "
               "bert_text_encoder.py:32-33); place an HF-style checkpoint at that path for "
               "parity")
        logger.warning(msg)
        print(f"warning: {msg}", flush=True)
    return BertConfig(hidden_size=hidden_size, num_hidden_layers=num_hidden_layers,
                      num_attention_heads=num_attention_heads,
                      intermediate_size=hidden_size * 4), None


def _load_bert_state(bert: BertModel, state: Dict[str, torch.Tensor], source) -> None:
    """Every tensor of `bert` from `state`; a checkpoint without the pooler
    keeps its initial pooler (it is not on the path), as flax's reader
    initialises missing weights. Anything else missing or misshapen raises."""
    want = bert.state_dict()
    missing = sorted(k for k in want if k not in state and not k.startswith("pooler."))
    bad = sorted(k for k in want if k in state and tuple(state[k].shape) != tuple(want[k].shape))
    if missing or bad:
        raise ValueError(f"BERT checkpoint {source}: missing {missing}, shape mismatch {bad}")
    kept = sorted(k for k in want if k not in state)
    if kept:
        logger.warning(f"BERT checkpoint {source} has no {kept}; kept their initial values")
    bert.load_state_dict({**want, **{k: v for k, v in state.items() if k in want}})
