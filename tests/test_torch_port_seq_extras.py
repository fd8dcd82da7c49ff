"""The port's sequence blocks (`mmtpu_torch/models/seq_extras.py`), the
attention they use (`models/transformer.py`), `LSTMClassifier`
(`models/lstm.py`) and `protocols.py` against mmtpu's, on the CPU.

Each class is held through `from_jax_variables` by `_recurrent_parity`:
forwards at 1e-5, gradients at 1e-4 of each parameter's norm, with every
dropout 0 (at the published defaults in eval mode), in eval mode and, for
the classes with BatchNorm, in train mode too: without BatchNorm and
dropout the two modes run the same arithmetic. `LSTMClassifier` runs
two G = 2 `lstm` launches per forward, counted through the kernel's plain
version; its pad-aware BatchNorm is held in train mode under a published
batch mask with padded rows, the running statistics included.
"""

import sys
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from mmtpu.models import lstm as jax_lstm
from mmtpu.models import norm as jax_norm
from mmtpu.models import protocols as jax_protocols
from mmtpu.models import seq_extras as jax_seq
from mmtpu.models.fc import FcClassifier as JaxFcClassifier
from mmtpu.models.registry import build_module as jax_build
from mmtpu_torch.checkpoints import from_jax_variables
from mmtpu_torch.models import build_module, lstm, norm, protocols, seq_extras
from mmtpu_torch.models.fc import FcClassifier
from mmtpu_torch.models.transformer import MultiHeadAttention

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _recurrent_parity import check as _check  # noqa: E402
from _torch_threads import few_threads  # noqa: E402,F401 — in-process comparisons only

B, T, TK = 3, 7, 5
NO_DROPOUT = dict(attn_dropout=0.0, relu_dropout=0.0, res_dropout=0.0)


def check(*args, train_modes=(False,), **kwargs):
    """Eval mode unless the class has BatchNorm (at dropout 0 train mode runs
    the same arithmetic); mmtpu's side op by op, its primitives compiled
    once per shape for the whole file."""
    return _check(*args, train_modes=train_modes, **kwargs)


def _x(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("n, dim", [(7, 8), (5, 9), (12, 2), (4, 3), (3, 1)])
def test_sinusoidal_table(n, dim):
    want = np.asarray(jax_seq.sinusoidal_positional_embedding(n, dim))
    got = seq_extras.sinusoidal_positional_embedding(n, dim)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    x = _x(2, n, dim)
    want = jax_seq.SinusoidalPositionalEmbedding(dim).apply({}, jnp.asarray(x))
    got = seq_extras.SinusoidalPositionalEmbedding(dim)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_future_mask():
    np.testing.assert_array_equal(seq_extras.future_mask(6).numpy(),
                                  np.asarray(jax_seq.future_mask(6)))


class _JaxMHA(fnn.Module):
    heads: int

    @fnn.compact
    def __call__(self, x, kv, mask=None, train=False):
        return fnn.MultiHeadDotProductAttention(num_heads=self.heads, name="attn")(
            x, kv, mask=None if mask is None else mask[None, None])


class _PortMHA(nn.Module):
    def __init__(self, d, heads, kv_dim):
        super().__init__()
        self.attn = MultiHeadAttention(d, heads, 0.0, kv_dim=kv_dim)

    def forward(self, x, kv, mask=None):
        return self.attn(x, kv, None if mask is None else mask[None, None])


@pytest.mark.parametrize("masked", [False, True])
def test_cross_attention(masked):
    """Queries from x (width 8), keys and values from kv (width 6, another
    length); the boolean mask takes flax's masked-logit value. A row the
    mask closes entirely is a uniform softmax in both."""
    mask = np.tril(np.ones((T, TK), bool)) if masked else None
    if masked:
        mask[0] = False
    check(_JaxMHA(2), _PortMHA(8, 2, 6), [_x(B, T, 8, seed=1), _x(B, TK, 6, seed=2), mask])


LAYER_FORMS = {
    "self": dict(attn_mask=False, source=False),
    "self_causal": dict(attn_mask=True, source=False),
    "cross_causal": dict(attn_mask=True, source=True),  # no causal mask across
}


@pytest.mark.parametrize("form", list(LAYER_FORMS))
def test_gated_encoder_layer(form):
    attn_mask, source = LAYER_FORMS[form]["attn_mask"], LAYER_FORMS[form]["source"]
    args = [_x(B, T, 8, seed=3), _x(B, TK, 8, seed=4) if source else None]
    check(jax_seq.GatedTransformerEncoderLayer(8, 2, attn_mask=attn_mask, **NO_DROPOUT),
          seq_extras.GatedTransformerEncoderLayer(8, 2, attn_mask=attn_mask,
                                                  kv_dim=8 if source else None, **NO_DROPOUT),
          args)


@pytest.mark.parametrize("source", [False, True])
@pytest.mark.parametrize("attn_mask", [False, True])
def test_gated_transformer(source, attn_mask):
    kw = dict(input_dim=5, embed_dim=6, num_heads=3, layers=2, attn_mask=attn_mask,
              embed_dropout=0.0, **NO_DROPOUT)
    check(jax_seq.GatedTransformer(**kw),
          seq_extras.GatedTransformer(**kw, source_dim=4 if source else None),
          [_x(B, T, 5, seed=5), _x(B, TK, 4, seed=6) if source else None])


def test_gated_transformer_published_dropouts_eval():
    """The class defaults (dropouts 0.1 / 0.25) leave eval untouched."""
    check(jax_seq.GatedTransformer(input_dim=5, embed_dim=8, num_heads=2, layers=2),
          seq_extras.GatedTransformer(input_dim=5, embed_dim=8, num_heads=2, layers=2),
          [_x(B, T, 5, seed=7)])


def test_source_without_source_dim_raises():
    with pytest.raises(ValueError, match="source_dim"):
        seq_extras.GatedTransformer(5, 8, 2, 1).eval()(torch.zeros(1, 3, 5), torch.zeros(1, 3, 5))


def _mask(lengths, T_, F_=4):
    return (np.arange(T_)[None, :, None] < np.asarray(lengths)[:, None, None]) \
        * np.ones((1, 1, F_), np.float32)


@pytest.mark.parametrize("masked", [False, True])
def test_lstm_classifier(masked):
    """Lengths 3, 7 and 1 from the mask (or none), in eval and train mode."""
    m = _mask([3, 7, 1], T) if masked else None
    check(jax_lstm.LSTMClassifier(4, 5, 6, 3, dropout_rate=0.0),
          lstm.LSTMClassifier(4, 5, 6, 3, dropout_rate=0.0), [_x(B, T, 4, seed=8), m],
          launches=[2, 2], train_modes=(False, True))


def test_lstm_classifier_mask_to_lengths_truncates():
    """sum(int(mean(mask, -1))): a step whose mask is partly open counts 0."""
    m = _mask([4, 2, 6], T)
    m[0, 1, 0] = 0.0  # step 1 of row 0 is no longer whole
    check(jax_lstm.LSTMClassifier(4, 3, 4, 2, dropout_rate=0.0),
          lstm.LSTMClassifier(4, 3, 4, 2, dropout_rate=0.0), [_x(B, T, 4, seed=9), m],
          launches=[2, 2])


def test_lstm_classifier_batchnorm_with_padded_rows():
    """Train mode under a published batch mask whose last two rows are
    padding: outputs, gradients and the updated running statistics."""
    B_ = 6
    x, m = _x(B_, T, 4, seed=10), _mask([7, 3, 5, 2, 0, 0], T)
    sample_mask = np.array([1, 1, 1, 1, 0, 0], np.float32)
    jm = jax_lstm.LSTMClassifier(4, 5, 6, 3, dropout_rate=0.0)
    v = jax.tree_util.tree_map(np.asarray, dict(jm.init(jax.random.PRNGKey(1), x, m)))
    pm = lstm.LSTMClassifier(4, 5, 6, 3, dropout_rate=0.0)
    pm.load_state_dict(from_jax_variables(v["params"], v["batch_stats"], target=pm))

    def jloss(p):
        with jax_norm.batch_mask(jnp.asarray(sample_mask)):
            (o, h), upd = jm.apply({"params": p, "batch_stats": v["batch_stats"]}, x, m,
                                   train=True, mutable=["batch_stats"])
        return jnp.sum(o * o) + jnp.sum(h), (o, h, upd)

    (_, (o, h, upd)), jgrads = jax.value_and_grad(jloss, has_aux=True)(v["params"])
    pm.train()
    with norm.batch_mask(torch.from_numpy(sample_mask)):
        po, ph = pm(torch.from_numpy(x), torch.from_numpy(m))
    ((po * po).sum() + ph.sum()).backward()
    np.testing.assert_allclose(po.detach().numpy(), np.asarray(o), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ph.detach().numpy(), np.asarray(h), rtol=1e-5, atol=1e-5)
    stats = upd["batch_stats"]["bn"]
    np.testing.assert_allclose(pm.bn.running_mean.numpy(), np.asarray(stats["mean"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pm.bn.running_var.numpy(), np.asarray(stats["var"]),
                               rtol=1e-5, atol=1e-6)
    grads = from_jax_variables(jax.tree_util.tree_map(np.asarray, jgrads), None, target=pm,
                               require_all=False)
    for name, p in pm.named_parameters():
        want = grads[name].numpy()
        assert np.abs(p.grad.numpy() - want).max() <= 1e-4 * max(np.linalg.norm(want), 1e-6), name


def _ef_pair(dropout=0.0):
    jax_model = jax_seq.EFModelAL(
        fc_classifier=JaxFcClassifier(input_dim=6, layers=[5], output_dim=4, dropout=0.0),
        lstm_classifier=jax_lstm.LSTMClassifier(4, 3, 5, 2, dropout_rate=dropout),
        out_dim_a=4, out_dim_v=5, fusion_size=7, num_class=3, dropout=dropout)
    port = seq_extras.EFModelAL(
        FcClassifier(input_dim=6, layers=[5], output_dim=4, dropout=0.0),
        lstm.LSTMClassifier(4, 3, 5, 2, dropout_rate=dropout),
        out_dim_a=4, out_dim_v=5, fusion_size=7, num_class=3, dropout=dropout)
    return jax_model, port


def test_ef_model_al():
    jax_model, port = _ef_pair()
    check(jax_model, port, [_x(B, 6, seed=11), _x(B, T, 4, seed=12), _mask([2, 7, 4], T)],
          launches=[2, 2], train_modes=(False, True))


def test_ef_model_al_default_dropout_eval_without_mask():
    jax_model, port = _ef_pair(dropout=0.3)
    check(jax_model, port, [_x(B, 6, seed=13), _x(B, T, 4, seed=14), None], launches=[2, 2])


def test_get_encoder_and_protocol():
    class Named(nn.Module):
        def __init__(self):
            super().__init__()
            self.audio_encoder = nn.Linear(2, 2)
            self.netV = nn.Linear(2, 3)

        def forward(self, x):
            return x

        def encode(self, x):
            return x

    class Bare:
        pass

    model = Named()
    for modality, want in (("audio", model.audio_encoder), ("video", model.netV)):
        assert protocols.get_encoder(model, modality) is want
        assert jax_protocols.get_encoder(model, modality) is want
    for package in (protocols, jax_protocols):
        with pytest.raises(ValueError, match="Unknown modality: text"):
            package.get_encoder(model, "text")
    assert isinstance(model, protocols.MultimodalModelProtocol)
    assert not isinstance(Bare(), protocols.MultimodalModelProtocol)


def test_registry_gated_transformer():
    kw = dict(input_dim=5, embed_dim=8, num_heads=2, layers=2, attn_mask=True)
    assert type(jax_build("gated_transformer", **kw)) is jax_seq.GatedTransformer
    check(jax_build("gated_transformer", **kw), build_module("gated_transformer", **kw),
          [_x(B, T, 5, seed=15)])
