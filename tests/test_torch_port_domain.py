"""The port's domain encoders (`mmtpu_torch/models/domain.py`) against
mmtpu's from the same variables, on the CPU.

Every class and form through `from_jax_variables`: forwards in eval and
train mode at 1e-5 and gradients at 1e-4 of each parameter's norm
(`_recurrent_parity`), with lengths below T, at T and past it in one batch
(and none where a form takes none); dropouts neutralised in both packages for the
train-mode parity. `lstm` launches per forward, counted through the
kernel's plain version: one G = 2 launch per bidirectional LSTM layer and
stream (DIVEncoder 2; SeqEncoder 3 per layer), none for a GRU (plain torch,
as mmtpu has no GRU kernel) or the linear and conv forms. The registry's
names build the same classes in both packages.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mmtpu.models import bert_text as jax_bert
from mmtpu.models import domain as jax_dom
from mmtpu.models.registry import build_module as jax_build
from mmtpu_torch.models import build_module
from mmtpu_torch.models import domain as dom

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _recurrent_parity import check, neutralise  # noqa: E402

B, T = 6, 7
LENGTHS = np.array([3, 7, 12, 1, 7, 30], np.int32)  # below T, at T and past it


def _x(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.fixture
def neutral():
    mp = pytest.MonkeyPatch()
    neutralise(mp, jax_dom)
    yield
    mp.undo()


def test_masked_avg_pool():
    x, ln = _x(B, T, 3), LENGTHS
    want = np.asarray(jax_dom.masked_avg_pool(x, ln))
    got = dom.masked_avg_pool(torch.from_numpy(x), torch.from_numpy(ln))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    mask = (np.arange(T)[None] < np.minimum(ln, 4)[:, None]).astype(np.float32)
    want = np.asarray(jax_dom.masked_avg_pool(x, ln, mask))
    got = dom.masked_avg_pool(torch.from_numpy(x), torch.from_numpy(ln), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


DIV_FORMS = {
    "linear_avg": dict(prj_type="linear", rdc_type="avg", use_disc=True),
    "linear_none": dict(prj_type="linear", rdc_type=None),
    "lstm_last": dict(prj_type="rnn", rnn_type="lstm", rdc_type="last"),
    "lstm_avg": dict(prj_type="rnn", rnn_type="LSTM", rdc_type="avg", use_disc=True),
    "gru_last": dict(prj_type="rnn", rnn_type="gru", rdc_type="last", use_disc=True),
    "gru_avg": dict(prj_type="rnn", rnn_type="gru", rdc_type="avg"),
}


@pytest.mark.parametrize("form", list(DIV_FORMS))
def test_div_encoder(neutral, form):
    kw = dict(DIV_FORMS[form], p_t=0.3, p_o=0.2)
    lstm = kw.get("rnn_type", "").lower() == "lstm"
    x_t, x_o = ((_x(B, 4, seed=1), _x(B, 4, seed=2)) if kw["rdc_type"] is None
                else (_x(B, T, 4, seed=1), _x(B, T, 4, seed=2)))
    check(jax_dom.DIVEncoder(4, 3, **kw), dom.DIVEncoder(4, 3, **kw), [x_t, x_o],
          {"lengths": LENGTHS}, launches=[2, 2] if lstm else [])


def test_div_encoder_without_lengths(neutral):
    """The bidirectional LSTM without lengths: flax's plain reverse and the
    state after step T."""
    kw = dict(prj_type="rnn", rnn_type="lstm", rdc_type="last", use_disc=True)
    check(jax_dom.DIVEncoder(4, 3, **kw), dom.DIVEncoder(4, 3, **kw),
          [_x(B, T, 4, seed=1), _x(B, T, 4, seed=2)], launches=[2, 2])


SEQ_FORMS = {
    "linear": dict(proj_type="linear"),
    "cnn": dict(proj_type="cnn", a_ksize=3, t_ksize=4, v_ksize=2),
    "lstm": dict(proj_type="lstm"),
    "lstm_two_layers": dict(proj_type="LSTM", num_enc_layers=2),
    "gru_two_layers": dict(proj_type="gru", num_enc_layers=2),
}


@pytest.mark.parametrize("form", list(SEQ_FORMS))
def test_seq_encoder(neutral, form):
    """Hidden sizes are the streams' input widths (3, 5, 4); the pooled
    state comes from the first layer's directions."""
    kw = SEQ_FORMS[form]
    layers = kw.get("num_enc_layers", 1)
    launches = [2] * (3 * layers) if kw["proj_type"].lower() == "lstm" else []
    check(jax_dom.SeqEncoder(3, 5, 4, 6, **kw), dom.SeqEncoder(3, 5, 4, 6, **kw),
          [_x(B, T, 5, seed=1), _x(B, T, 4, seed=2), _x(B, T, 3, seed=3),
           LENGTHS], launches=launches)


def test_language_embedding_table(neutral):
    ids = np.random.default_rng(0).integers(0, 11, size=(B, T)).astype(np.int32)
    check(jax_dom.LanguageEmbeddingLayer(False, 11, 4), dom.LanguageEmbeddingLayer(False, 11, 4),
          [], {"sentences": ids}, launches=[])


class _TinyJaxBert(jax_bert.BertTextEncoder):
    pretrained_path: str = ""
    hidden_size: int = 16
    num_hidden_layers: int = 2
    num_attention_heads: int = 2


class _TinyBert(dom.BertTextEncoder):
    def __init__(self, pretrained_path=""):
        super().__init__(pretrained_path="", hidden_size=16, num_hidden_layers=2,
                         num_attention_heads=2)


def test_language_embedding_bert(neutral):
    """The BERT form at a tiny width (both packages' BertTextEncoder
    defaults narrowed for the test): frozen, so its gradients are 0 in
    both."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_bert, "BertTextEncoder", _TinyJaxBert)
    mp.setattr(dom, "BertTextEncoder", _TinyBert)
    try:
        g = np.random.default_rng(1)
        ids = g.integers(1, 50, size=(B, T)).astype(np.int32)
        mask = (np.arange(T)[None] < np.minimum(LENGTHS, T)[:, None]).astype(np.int32)
        types = np.zeros((B, T), np.int32)
        kw = {"bert_sent": ids, "bert_sent_type": types, "bert_sent_mask": mask}
        check(jax_dom.LanguageEmbeddingLayer(True, bert_pretrained_path=""),
              dom.LanguageEmbeddingLayer(True, bert_pretrained_path=""), [], kw,
              launches=[], train_modes=(False,))
    finally:
        mp.undo()


def test_errors_match_mmtpu():
    with pytest.raises(ValueError, match="rnn_type must be specified"):
        dom.DIVEncoder(4, 3, prj_type="rnn", rdc_type="last")
    with pytest.raises(ValueError, match="'last' or 'avg' for RNN"):
        dom.DIVEncoder(4, 3, prj_type="rnn", rnn_type="lstm")
    with pytest.raises(ValueError, match="'avg' or None for linear"):
        dom.DIVEncoder(4, 3, rdc_type="last")
    with pytest.raises(ValueError, match="prj_type must be"):
        dom.DIVEncoder(4, 3, prj_type="cnn")
    with pytest.raises(ValueError, match="needs lengths"):
        dom.DIVEncoder(4, 3, rdc_type="avg")(torch.zeros(2, 3, 4), torch.zeros(2, 3, 4))
    with pytest.raises(ValueError, match="proj_type must be one of"):
        dom.SeqEncoder(3, 5, 4, 6, proj_type="mlp")
    with pytest.raises(ValueError, match="both vocab_size and embedding_dim"):
        dom.LanguageEmbeddingLayer(False, 11)
    with pytest.raises(ValueError, match="Sentences input"):
        dom.LanguageEmbeddingLayer(False, 11, 4)()


REGISTRY = {
    "div_encoder": {"in_size": 4, "out_size": 3},
    "divencoder": {"in_size": 4, "out_size": 3, "prj_type": "rnn", "rnn_type": "gru",
                   "rdc_type": "avg"},
    "seq_encoder": {"orig_dim_a": 3, "orig_dim_t": 5, "orig_dim_v": 4, "attention_dim": 6},
    "seqencoder": {"orig_dim_a": 3, "orig_dim_t": 5, "orig_dim_v": 4, "attention_dim": 6,
                   "proj_type": "lstm"},
    "language_embedding": {"use_bert": False, "vocab_size": 11, "embedding_dim": 4},
    "languageembeddinglayer": {"use_bert": False, "vocab_size": 11, "embedding_dim": 4},
}


@pytest.mark.parametrize("name", list(REGISTRY))
def test_registry_names_build_mmtpus_classes(name):
    assert type(build_module(name, **REGISTRY[name])).__name__ == type(
        jax_build(name, **REGISTRY[name])).__name__
