"""C-MAM, the cross-modal association model (counterpart of
mmtpu/models/cmam.py).

`CMAM`: one encoder per input modality, run in sorted modality order, their
embeddings fused by concat, sum or mean, then an `AssociationNetwork`
(fc_0 → optional pad-aware BatchNorm `bn` → ReLU → dropout → fc_1) that
predicts the TARGET modality's embedding. `DualCMAM`: one input encoder and
two decoders (Linear → ReLU → dropout → Linear) predicting two target
modalities' embeddings. Both are trained against a frozen base model
(`train/cmam_step.py`).

State-dict keys follow mmtpu's names: `input_encoders.{mod}.…` (mmtpu's
`input_encoders_{mod}`), `assoc.fc_0`, `assoc.bn`, `assoc.fc_1`; DualCMAM's
`encoder.…`, `decoder_one_fc_0`, `decoder_one_fc_1`, `decoder_two_fc_0`,
`decoder_two_fc_1`.

Their dropout draws its masks from the run's `torch.Generator`
(`models/rng.py`).
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from mmtpu_torch.config.spec import ModuleSpec
from mmtpu_torch.modalities import Modality
from mmtpu_torch.models.norm import BatchNorm
from mmtpu_torch.models.rng import GeneratorDropout


class AssociationNetwork(nn.Module):
    def __init__(self, input_size: int, hidden_size: int, output_size: int,
                 batch_norm: bool = False, dropout: float = 0.0) -> None:
        super().__init__()
        self.fc_0 = nn.Linear(input_size, hidden_size)
        self.bn = BatchNorm(hidden_size) if batch_norm else None
        self.dropout = GeneratorDropout(dropout) if dropout > 0 else None
        self.fc_1 = nn.Linear(hidden_size, output_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.fc_0(x)
        if self.bn is not None:
            x = self.bn(x)
        x = torch.relu(x)
        if self.dropout is not None:
            x = self.dropout(x)
        return self.fc_1(x)


class InputEncoders(dict):
    """Modality → encoder module or spec (YAML `!InputEncoders`)."""

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "InputEncoders":
        return cls(data)


def _coerce_encoders(input_encoders) -> Dict[str, Any]:
    """Keys normalised through Modality; specs built into modules."""
    return {str(Modality(str(k))): v.build() if isinstance(v, ModuleSpec) else v
            for k, v in dict(input_encoders).items()}


class CMAM(nn.Module):
    def __init__(self, input_encoders, association_network, target_modality,
                 fusion_fn: str = "concat", grad_clip: float = 0.0,
                 labels_key: str = "labels", load_pretrained_encoder_state_for=()) -> None:
        super().__init__()
        self.input_encoders = nn.ModuleDict(_coerce_encoders(input_encoders))
        net = association_network
        if isinstance(net, ModuleSpec):
            net = net.build()
        elif isinstance(net, dict):  # constructor kwargs
            net = AssociationNetwork(**net)
        self.assoc = net
        self.target_modality = target_modality
        self.fusion_fn = fusion_fn
        self.grad_clip = grad_clip
        self.labels_key = labels_key
        self.load_pretrained_encoder_state_for = tuple(load_pretrained_encoder_state_for or ())

    def forward(self, modalities: Dict[str, torch.Tensor]) -> torch.Tensor:
        embeddings = [self.input_encoders[k](modalities[k]) for k in sorted(self.input_encoders)]
        fn = self.fusion_fn.lower()
        if fn == "concat":
            z = torch.cat(embeddings, dim=1)
        elif fn == "sum":
            z = torch.stack(embeddings).sum(0)
        elif fn == "mean":
            z = torch.stack(embeddings).mean(0)
        else:
            raise ValueError(f"Unknown fusion function: {self.fusion_fn}")
        return self.assoc(z)


class DualCMAM(nn.Module):
    """One input-modality encoder feeding two decoders, each reconstructing
    one target modality's embedding; returns (one, two)."""

    def __init__(self, input_encoder, shared_encoder_output_size: int,
                 decoder_hidden_size: int, target_modality_one_embd_size: int,
                 target_modality_two_embd_size: int, input_modality: Any = "audio",
                 target_modality_one: Any = "video", target_modality_two: Any = "text",
                 dropout: float = 0.1, grad_clip: float = 0.0, binarize: bool = False,
                 load_pretrained_encoder_state_for=()) -> None:
        super().__init__()
        enc = input_encoder
        if isinstance(enc, ModuleSpec):
            enc = enc.build()
        elif isinstance(enc, dict):  # {modality: encoder}: its single entry
            enc = _coerce_encoders(enc)
            enc = enc[sorted(enc)[0]]
        self.encoder = enc
        self.input_modality = input_modality
        self.target_modality_one = target_modality_one
        self.target_modality_two = target_modality_two
        self.grad_clip = grad_clip
        self.binarize = binarize
        self.load_pretrained_encoder_state_for = tuple(load_pretrained_encoder_state_for or ())
        for name, out_size in (("decoder_one", target_modality_one_embd_size),
                               ("decoder_two", target_modality_two_embd_size)):
            setattr(self, f"{name}_fc_0", nn.Linear(shared_encoder_output_size,
                                                    decoder_hidden_size))
            setattr(self, f"{name}_dropout", GeneratorDropout(dropout))
            setattr(self, f"{name}_fc_1", nn.Linear(decoder_hidden_size, out_size))

    def _decode(self, name: str, h: torch.Tensor) -> torch.Tensor:
        z = torch.relu(getattr(self, f"{name}_fc_0")(h))
        return getattr(self, f"{name}_fc_1")(getattr(self, f"{name}_dropout")(z))

    def forward(self, x: torch.Tensor):
        h = self.encoder(x)
        return self._decode("decoder_one", h), self._decode("decoder_two", h)
