"""Self-MM (counterpart of mmtpu/models/self_mm.py): AuViSubNet and Self_MM.

`AuViSubNet`: a stacked, optionally bidirectional LSTM over the audio or
video sequence → dropout → `linear_1`. It computes flax's
`nn.RNN(OptimizedLSTMCell, return_carry=True)` with `seq_lengths`, as
mmtpu does, on the `lstm` kernel (`ops/lstm.py`: on a CUDA tensor the
hand-written kernel, on the CPU the plain scan): each cell's per-gate
weights are concatenated into the kernel's fused layout (`RNNCell`) and
the recurrence runs over every step without lengths; the final h is the
output at step len − 1 (`carry_at`: len 0 wraps to the last step, len > T
is clamped to it with no gradient through it, as JAX's gather does). The
reverse direction of a bidirectional layer runs on flax's
`flip_sequences` of the input: within each row the first len steps
reversed and the rest after them, as the index (T − 1 − t + len) mod T
gives them, which for len > T is a rotation of the reversed row, not the
reversed row. Its carry is picked the same way, and its outputs are
flipped back (`keep_order=True`). The two directions of a layer run in one
launch (G = 2); both read the previous layer's concatenated outputs.
Dropout goes between stacked layers and once on the final h. The cells
are named as mmtpu's tree names them, `OptimizedLSTMCell_{n}` in creation
order (flax binds a cell given to `nn.RNN` to the RNN's parent): forward,
then backward, layer by layer. Not `pack_padded_sequence`/cuDNN, which
rejects len > T, and Self-MM reaches it (text lengths in the audio and
video LSTMs, an all-zero text mask counting as 50 steps).

`Self_MM`: BERT's [CLS] state and the two AuViSubNets, a fusion regressor
and three unimodal regressors (each dropout → Linear → ReLU → Linear →
ReLU → Linear to 1). The text lengths are the mask row's sums, 0 → 50.
As the reference (and mmtpu) does, `need_data_aligned: false` routes the
TEXT lengths into the audio and video LSTMs and `true` their own. Returns
mmtpu's dict of `predictions`, `features` and `features_pre_activation`,
keyed by modality name. The label banks live in `train/managers.py`, the
step in `train/self_mm_step.py`.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from mmtpu_torch.models.lstm import RNNCell, carry_at
from mmtpu_torch.models.rng import GeneratorDropout
from mmtpu_torch.ops.lstm import lstm_sequence_stacked

DEFAULT_TEXT_LENGTH = 50


def flip_sequences(x: torch.Tensor, lengths: Optional[torch.Tensor]) -> torch.Tensor:
    """flax's `flip_sequences` over (B, T, ...) batch-major rows: row b's
    step t taken from step (T − 1 − t + len_b) mod T; a plain reverse
    without lengths. Its own inverse."""
    T = x.shape[1]
    if lengths is None:
        return torch.flip(x, dims=(1,))
    steps = torch.arange(T - 1, -1, -1, device=x.device)
    idx = (steps[None, :] + lengths.to(device=x.device, dtype=torch.long)[:, None]) % T
    idx = idx.reshape(*idx.shape, *([1] * (x.dim() - 2))).expand_as(x)
    return torch.gather(x, 1, idx)


class AuViSubNet(nn.Module):
    def __init__(self, in_size: int, hidden_size: int, out_size: int, num_layers: int = 1,
                 dropout: float = 0.2, bidirectional: bool = False) -> None:
        super().__init__()
        self.in_size = in_size
        self.hidden_size = hidden_size
        self.out_size = out_size
        self.num_layers = num_layers
        self.bidirectional = bool(bidirectional)
        directions = 2 if self.bidirectional else 1
        for layer in range(num_layers):
            width = in_size if layer == 0 else hidden_size * directions
            for d in range(directions):
                self.add_module(f"OptimizedLSTMCell_{layer * directions + d}",
                                RNNCell(width, hidden_size))
        self.dropout = GeneratorDropout(dropout)
        self.linear_1 = nn.Linear(hidden_size * directions, out_size)

    def get_embedding_size(self) -> int:
        return self.out_size

    def _cell(self, n: int) -> RNNCell:
        return getattr(self, f"OptimizedLSTMCell_{n}")

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        directions = 2 if self.bidirectional else 1
        h = x
        final_h = None
        for layer in range(self.num_layers):
            ins = [h] if directions == 1 else [h, flip_sequences(h, lengths)]
            projected = [self._cell(layer * directions + d).project(inp)
                         for d, inp in enumerate(ins)]
            outs, (hT, _) = lstm_sequence_stacked([p[0] for p in projected],
                                                  [p[1] for p in projected])
            carries = [hT[d] if lengths is None else carry_at(outs[d], lengths)
                       for d in range(directions)]
            if directions == 1:
                h, final_h = outs[0], carries[0]
            else:
                h = torch.cat([outs[0], flip_sequences(outs[1], lengths)], dim=-1)
                final_h = torch.cat(carries, dim=-1)
            if layer < self.num_layers - 1:
                h = self.dropout(h)
        return self.linear_1(self.dropout(final_h))


class Self_MM(nn.Module):  # noqa: N801 (mmtpu's and the reference's name)
    def __init__(self, audio_encoder: nn.Module, video_encoder: nn.Module,
                 text_encoder: nn.Module, need_data_aligned: bool, audio_out: int,
                 video_out: int, text_out: int, post_fusion_dropout: float,
                 post_fusion_dim: int, post_text_dropout: float, post_text_dim: int,
                 post_audio_dropout: float, post_audio_dim: int, post_video_dropout: float,
                 post_video_dim: int, feature_manager: Any = None, labels_manager: Any = None,
                 center_manager: Any = None, H: float = 3.0, update_every: int = 1) -> None:
        super().__init__()
        self.audio_encoder = audio_encoder
        self.video_encoder = video_encoder
        self.text_encoder = text_encoder
        self.need_data_aligned = bool(need_data_aligned)
        self.H = float(H)
        self.update_every = update_every
        # the widths the Dense layers infer in flax: the encoders' outputs
        widths = {"text": text_encoder.get_embedding_size(),
                  "audio": audio_encoder.get_embedding_size(),
                  "video": video_encoder.get_embedding_size()}
        widths["fusion"] = sum(widths.values())
        dims = {"fusion": post_fusion_dim, "text": post_text_dim, "audio": post_audio_dim,
                "video": post_video_dim}
        drops = {"fusion": post_fusion_dropout, "text": post_text_dropout,
                 "audio": post_audio_dropout, "video": post_video_dropout}
        for name in ("fusion", "text", "audio", "video"):
            self.add_module(f"post_{name}_dropout", GeneratorDropout(drops[name]))
            self.add_module(f"post_{name}_layer_1", nn.Linear(widths[name], dims[name]))
            self.add_module(f"post_{name}_layer_2", nn.Linear(dims[name], dims[name]))
            self.add_module(f"post_{name}_layer_3", nn.Linear(dims[name], 1))

    def _head(self, name: str, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(prediction, feature) of one regressor."""
        layer = lambda i: getattr(self, f"post_{name}_layer_{i}")  # noqa: E731
        feature = torch.relu(layer(1)(getattr(self, f"post_{name}_dropout")(x)))
        return layer(3)(torch.relu(layer(2)(feature))), feature

    def forward(self, A, V, T: torch.Tensor) -> Dict[str, Dict[str, torch.Tensor]]:
        """A, V: (sequence, lengths or None); T: (B, 3, T) BERT rows."""
        audio, audio_lengths = A
        video, video_lengths = V
        mask_len = T[:, 1, :].sum(dim=1).to(torch.int32)
        text_lengths = torch.where(mask_len == 0, DEFAULT_TEXT_LENGTH, mask_len)
        text = self.text_encoder(T)[:, 0, :]
        if not self.need_data_aligned:
            audio = self.audio_encoder(audio, text_lengths)
            video = self.video_encoder(video, text_lengths)
        else:
            audio = self.audio_encoder(audio, audio_lengths)
            video = self.video_encoder(video, video_lengths)
        out_fusion, fusion_h = self._head("fusion", torch.cat([text, audio, video], dim=-1))
        out_text, text_h = self._head("text", text)
        out_audio, audio_h = self._head("audio", audio)
        out_video, video_h = self._head("video", video)
        return {
            "predictions": {"multimodal": out_fusion, "audio": out_audio,
                            "video": out_video, "text": out_text},
            "features": {"multimodal": fusion_h, "audio": audio_h, "video": video_h,
                         "text": text_h},
            "features_pre_activation": {"audio": audio, "video": video, "text": text},
        }
