"""Domain-invariant and multimodal sequence encoders (counterpart of
mmtpu/models/domain.py): `DIVEncoder`, `SeqEncoder`,
`LanguageEmbeddingLayer`.

Batch-first (B, T, F) throughout, as in mmtpu. A bidirectional LSTM layer
is flax's pair of `nn.RNN(OptimizedLSTMCell, return_carry=True)` scans with
`seq_lengths`, run as AuViSubNet's is: both directions in ONE `lstm` launch
(G = 2) over every step, the backward one on `flip_sequences` of its input,
each final h the output at step len − 1 (`bidirectional_lstm`,
`models/lstm.py`). A GRU layer is the same pair of flax `GRUCell` scans in
plain torch: mmtpu has no GRU kernel. The cells are named as mmtpu's tree
names them: flax binds a cell given to `nn.RNN` to the RNN's parent, so
they are `OptimizedLSTMCell_{n}` or `GRUCell_{n}` in creation order —
forward then backward, layer by layer, stream by stream.

- `DIVEncoder`: linear or bidirectional-RNN projections of two streams to
  a shared space, 'avg' (masked mean) or 'last' reduction, per-stream
  dropout (from the run's generator), and an optional discriminator:
  sigmoid scores over [enc_l; enc_o] stacked along the batch, labels 0 for
  the first stream and 1 for the second. Returns (enc_l, enc_o, disc_out,
  disc_labels); the last two are None without `use_disc`.
- `SeqEncoder`: text, video and audio (in that order) projected to
  `attention_dim` by a Linear, a same-padded bias-free 1-D convolution, or
  stacked bidirectional LSTM or GRU layers whose hidden size is the
  stream's INPUT width (a reference quirk mmtpu keeps). Returns
  {Modality: (seq (B, T, D), pooled (B, D))}: the linear and conv paths
  pool by masked mean; the RNN path pools Dense + LayerNorm (flax's,
  eps 1e-6) over the FIRST layer's final states (the reference's
  h_out[0] / h_out[1], which equal the last layer's only for one layer).
- `LanguageEmbeddingLayer`: the port's `BertTextEncoder` (`bert_model`)
  over stacked (ids, mask, type) rows, or an `nn.Embedding` (`embed`).
  Its parameters exist from construction, so a missing vocabulary raises
  there, where mmtpu's lazily built flax module raises at its first call
  (so do the other two classes' invalid options).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from mmtpu_torch.modalities import Modality
from mmtpu_torch.models.bert_text import BertTextEncoder, FlaxLayerNorm
from mmtpu_torch.models.lstm import RNNCell, bidirectional_lstm, carry_at, flip_sequences
from mmtpu_torch.models.rng import GeneratorDropout


def masked_avg_pool(x: torch.Tensor, lengths: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, T, F) → (B, F): the sum over the valid steps divided by the
    lengths (a length past T divides the whole sum by it)."""
    lengths = lengths.to(x.device)
    if mask is None:
        steps = torch.arange(x.shape[1], device=x.device)
        mask = (steps[None, :] < lengths[:, None]).to(x.dtype)
    if mask.dim() == 2:
        mask = mask[..., None]
    return (x * mask).sum(dim=1) / lengths[:, None].to(x.dtype)


class GRUCell(nn.ModuleDict):
    """flax's `GRUCell` parameters: `ir`, `iz`, `in` over the input (with
    bias), `hr`, `hz` over h (no bias) and `hn` over h (with bias)."""

    def __init__(self, input_size: int, hidden_size: int) -> None:
        super().__init__()
        for gate in ("ir", "iz", "in"):
            self[gate] = nn.Linear(input_size, hidden_size)
        for gate in ("hr", "hz", "hn"):
            self[gate] = nn.Linear(hidden_size, hidden_size, bias=gate == "hn")
            nn.init.orthogonal_(self[gate].weight)

    def sequence(self, x: torch.Tensor) -> torch.Tensor:
        """The outputs (B, T, H) of the scan from a zero state over every step:
        r = σ(x·Wir + bir + h·Whr), z = σ(x·Wiz + biz + h·Whz),
        n = tanh(x·Win + bin + r·(h·Whn + bhn)), h' = (1 − z)·n + z·h."""
        xr, xz, xn = self["ir"](x), self["iz"](x), self["in"](x)
        h = x.new_zeros((x.shape[0], self["hr"].weight.shape[0]))
        outs = []
        for t in range(x.shape[1]):
            r = torch.sigmoid(xr[:, t] + self["hr"](h))
            z = torch.sigmoid(xz[:, t] + self["hz"](h))
            n = torch.tanh(xn[:, t] + r * self["hn"](h))
            h = (1.0 - z) * n + z * h
            outs.append(h)
        return torch.stack(outs, dim=1)


def bidirectional_gru(fwd: GRUCell, bwd: GRUCell, x: torch.Tensor,
                      lengths: Optional[torch.Tensor] = None):
    """`bidirectional_lstm`'s contract for a GRU pair, in plain torch."""
    out_f = fwd.sequence(x)
    out_b = bwd.sequence(flip_sequences(x, lengths))
    if lengths is None:
        h_f, h_b = out_f[:, -1], out_b[:, -1]
    else:
        h_f, h_b = carry_at(out_f, lengths), carry_at(out_b, lengths)
    return torch.cat([out_f, flip_sequences(out_b, lengths)], dim=-1), h_f, h_b


class _BiRNNHost(nn.Module):
    """A module that owns flax-named recurrent cells, numbered in creation
    order, and runs them in bidirectional pairs."""

    def _add_pair(self, rnn_type: str, input_size: int, hidden_size: int) -> Tuple[str, str]:
        cls, prefix = (GRUCell, "GRUCell") if rnn_type == "gru" else (
            RNNCell, "OptimizedLSTMCell")
        names = []
        for _ in range(2):
            name = f"{prefix}_{self._cells}"
            self.add_module(name, cls(input_size, hidden_size))
            self._cells += 1
            names.append(name)
        return names[0], names[1]

    def _bi_rnn(self, pair: Tuple[str, str], x: torch.Tensor,
                lengths: Optional[torch.Tensor]):
        fwd, bwd = (getattr(self, n) for n in pair)
        run = bidirectional_gru if isinstance(fwd, GRUCell) else bidirectional_lstm
        return run(fwd, bwd, x, lengths)


class DIVEncoder(_BiRNNHost):
    def __init__(self, in_size: int, out_size: int, prj_type: str = "linear",
                 use_disc: bool = False, rnn_type: Optional[str] = None,
                 rdc_type: Optional[str] = None, p_t: float = 0.0, p_o: float = 0.0) -> None:
        super().__init__()
        self.out_size = out_size
        self.prj_type = prj_type
        self.use_disc = bool(use_disc)
        self.rdc_type = rdc_type
        self._cells = 0
        if prj_type == "linear":
            if rdc_type not in ("avg", None):
                raise ValueError("Reduce method must be 'avg' or None for linear projection")
            self.encode_l = nn.Linear(in_size, out_size)
            self.encode_o = nn.Linear(in_size, out_size)
        elif prj_type == "rnn":
            if rnn_type is None:
                raise ValueError("rnn_type must be specified when using RNN projection")
            if rdc_type not in ("last", "avg"):
                raise ValueError("Reduce method must be 'last' or 'avg' for RNN projection")
            kind = rnn_type.lower()
            self._pair_l = self._add_pair(kind, in_size, out_size)
            self._pair_o = self._add_pair(kind, in_size, out_size)
        else:
            raise ValueError("prj_type must be either 'linear' or 'rnn'")
        self.dropout_t = GeneratorDropout(p_t)
        self.dropout_o = GeneratorDropout(p_o)
        if self.use_disc:
            self.disc_fc1 = nn.Linear(out_size, 4 * out_size)
            self.disc_fc2 = nn.Linear(4 * out_size, 1)

    def _reduce_avg(self, x, lengths, mask):
        if lengths is None:
            raise ValueError("rdc_type='avg' needs lengths")
        return masked_avg_pool(x, lengths, mask)

    def forward(self, input_t: torch.Tensor, input_o: torch.Tensor,
                lengths: Optional[torch.Tensor] = None, mask: Optional[torch.Tensor] = None):
        if self.prj_type == "linear":
            if self.rdc_type == "avg":
                input_t = self._reduce_avg(input_t, lengths, mask)
                input_o = self._reduce_avg(input_o, lengths, mask)
            enc_l, enc_o = self.encode_l(input_t), self.encode_o(input_o)
        else:
            out_l, hf_l, hb_l = self._bi_rnn(self._pair_l, input_t, lengths)
            out_o, hf_o, hb_o = self._bi_rnn(self._pair_o, input_o, lengths)
            if self.rdc_type == "last":
                enc_l, enc_o = (hf_l + hb_l) / 2, (hf_o + hb_o) / 2
            else:  # the masked mean, then the two directions' halves averaged
                half = self.out_size
                enc_l = self._reduce_avg(out_l, lengths, mask)
                enc_o = self._reduce_avg(out_o, lengths, mask)
                enc_l = (enc_l[:, :half] + enc_l[:, half:]) / 2
                enc_o = (enc_o[:, :half] + enc_o[:, half:]) / 2
        enc_l, enc_o = self.dropout_t(enc_l), self.dropout_o(enc_o)
        if not self.use_disc:
            return enc_l, enc_o, None, None
        both = torch.cat([enc_l, enc_o], dim=0)
        disc_out = torch.sigmoid(self.disc_fc2(torch.relu(self.disc_fc1(both))))[..., 0]
        b = enc_l.shape[0]
        disc_labels = torch.cat([enc_l.new_zeros((b,)), enc_l.new_ones((b,))])
        return enc_l, enc_o, disc_out, disc_labels


class SeqEncoder(_BiRNNHost):
    def __init__(self, orig_dim_a: int, orig_dim_t: int, orig_dim_v: int, attention_dim: int,
                 num_enc_layers: int = 1, proj_type: str = "linear", a_ksize: int = 3,
                 t_ksize: int = 3, v_ksize: int = 3) -> None:
        super().__init__()
        self.proj_type = proj_type.lower()
        if self.proj_type not in ("linear", "cnn", "lstm", "gru"):
            raise ValueError("proj_type must be one of: 'linear', 'cnn', 'lstm', 'gru'")
        self.num_enc_layers = num_enc_layers
        self._cells = 0
        # mmtpu's stream order: text, video, audio
        self.streams = (("t", Modality.TEXT, orig_dim_t, t_ksize),
                        ("v", Modality.VIDEO, orig_dim_v, v_ksize),
                        ("a", Modality.AUDIO, orig_dim_a, a_ksize))
        self._pairs: Dict[str, list] = {}
        for tag, _, dim, ksize in self.streams:
            if self.proj_type == "linear":
                self.add_module(f"proj_{tag}", nn.Linear(dim, attention_dim))
            elif self.proj_type == "cnn":
                self.add_module(f"proj_{tag}",
                                nn.Conv1d(dim, attention_dim, ksize, bias=False))
            else:
                self._pairs[tag] = [
                    self._add_pair(self.proj_type, dim if layer == 0 else 2 * dim, dim)
                    for layer in range(num_enc_layers)]
                self.add_module(f"proj_{tag}_h", nn.Linear(2 * dim, attention_dim))
                self.add_module(f"layer_norm_{tag}", FlaxLayerNorm(attention_dim, eps=1e-6))
                self.add_module(f"proj_{tag}_seq", nn.Linear(2 * dim, attention_dim))

    def forward(self, input_t: torch.Tensor, input_v: torch.Tensor, input_a: torch.Tensor,
                lengths: torch.Tensor) -> Dict[Modality, Tuple[torch.Tensor, torch.Tensor]]:
        inputs = {"t": input_t, "v": input_v, "a": input_a}
        out = {}
        for tag, modality, _, ksize in self.streams:
            x = inputs[tag]
            if self.proj_type == "linear":
                seq = getattr(self, f"proj_{tag}")(x)
                pooled = masked_avg_pool(seq, lengths)
            elif self.proj_type == "cnn":  # flax's SAME: (k − 1) // 2 steps before
                left = (ksize - 1) // 2
                padded = F.pad(x.transpose(1, 2), (left, ksize - 1 - left))
                seq = getattr(self, f"proj_{tag}")(padded).transpose(1, 2)
                pooled = masked_avg_pool(seq, lengths)
            else:
                h, first_h = x, None
                for layer, pair in enumerate(self._pairs[tag]):
                    h, h_f, h_b = self._bi_rnn(pair, h, lengths)
                    if layer == 0:
                        first_h = torch.cat([h_f, h_b], dim=-1)
                pooled = getattr(self, f"layer_norm_{tag}")(
                    getattr(self, f"proj_{tag}_h")(first_h))
                seq = getattr(self, f"proj_{tag}_seq")(h)
            out[modality] = (seq, pooled)
        return out


class LanguageEmbeddingLayer(nn.Module):
    def __init__(self, use_bert: bool, vocab_size: Optional[int] = None,
                 embedding_dim: Optional[int] = None,
                 bert_pretrained_path: str = "pretrained_model/bert_en") -> None:
        super().__init__()
        self.use_bert = bool(use_bert)
        if self.use_bert:
            self.bert_model = BertTextEncoder(pretrained_path=bert_pretrained_path)
            return
        if vocab_size is None or embedding_dim is None:
            raise ValueError("For GloVe embeddings, both vocab_size and embedding_dim "
                             "must be provided")
        self.embed = nn.Embedding(vocab_size, embedding_dim)

    def forward(self, sentences: Optional[torch.Tensor] = None,
                bert_sent: Optional[torch.Tensor] = None,
                bert_sent_type: Optional[torch.Tensor] = None,
                bert_sent_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.use_bert:
            if any(x is None for x in (bert_sent, bert_sent_type, bert_sent_mask)):
                raise ValueError("All BERT inputs must be provided when use_bert=True")
            # BertTextEncoder's packed rows: ids / mask / type
            return self.bert_model(torch.stack([bert_sent, bert_sent_mask, bert_sent_type],
                                               dim=1))
        if sentences is None:
            raise ValueError("Sentences input must be provided when use_bert=False")
        return self.embed(sentences.long())
