"""The port's GCNet (`mmtpu_torch/models/gcnet.py`, `train/gcnet_loss.py`)
against mmtpu's, on the CPU.

- the dense adjacencies: windows −1 and finite, the temporal relations,
  the speaker relations for one and two speakers, bit for bit;
- `DenseRGCNConv`, `DenseGraphConv`, `MatchingAttention` (all four types,
  with a mask and a 2-D candidate) and `GraphModel` (LSTM and GRU bases,
  one and two speakers, windows −1 and finite, with and without time
  attention, a padded batch: lengths below T) through `from_jax_variables`
  (`_recurrent_parity`, eval mode at dropout 0, where train mode runs the
  same arithmetic): forwards at 1e-5 over the whole tensors, pad rows
  included, gradients at 1e-4 of each parameter's norm;
- the `lstm` launches per GraphModel forward, counted through the kernel's
  plain version: 6 G = 2 launches with the LSTM base (2 base layers and 2
  fusion layers in each graph net), 4 with the GRU base (plain torch);
- mmtpu's own pad-length invariance (`tests/test_gcnet.py`) in the port;
- the three masked losses at 1e-6; the options both packages refuse; the
  full GraphModel tree converted with `require_all=True`, no leaf left
  over; the registry's names.

The launches of one GCNet forward on the card are held by a `cuda` test in
`test_torch_port_lstm.py`, which the card's machine (no JAX) can import.
"""

import sys
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmtpu.models import gcnet as jax_gcnet
from mmtpu.models.registry import build_module as jax_build
from mmtpu.train import gcnet_loss as jax_loss
from mmtpu_torch.checkpoints import from_jax_variables
from mmtpu_torch.models import build_module, gcnet
from mmtpu_torch.train import gcnet_loss

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _recurrent_parity import check as _check  # noqa: E402
from _torch_threads import few_threads  # noqa: E402,F401 — in-process comparisons only

B, T = 3, 8
ADIM, TDIM, VDIM = 3, 4, 2
LENGTHS = np.array([8, 5, 2], np.int32)


def check(*args, **kwargs):
    """Eval mode; mmtpu's side op by op (its primitives compile once per
    shape for the whole file)."""
    return _check(*args, train_modes=(False,), **kwargs)


def _x(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _conversations(seed=0, T_=T, lengths=LENGTHS):
    g = np.random.default_rng(seed)
    feats = g.normal(size=(B, T_, ADIM + TDIM + VDIM)).astype(np.float32)
    qmask = g.integers(0, 2, (B, T_)).astype(np.int32)
    umask = (np.arange(T_)[None] < lengths[:, None]).astype(np.float32)
    return feats, qmask, umask, lengths


@pytest.mark.parametrize("window", [(-1, -1), (2, 1), (0, 3)])
def test_adjacencies(window):
    _, qmask, _, lengths = _conversations()
    want = np.asarray(jax_gcnet.window_adjacency(T, jnp.asarray(lengths), *window))
    got = gcnet.window_adjacency(T, torch.from_numpy(lengths), *window)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        gcnet.temporal_relation_adjacency(got).numpy(),
        np.asarray(jax_gcnet.temporal_relation_adjacency(jnp.asarray(want))))
    for n in (1, 2):
        np.testing.assert_array_equal(
            gcnet.speaker_relation_adjacency(got, torch.from_numpy(qmask), n).numpy(),
            np.asarray(jax_gcnet.speaker_relation_adjacency(jnp.asarray(want),
                                                            jnp.asarray(qmask), n)))


class _Bare(fnn.Module):
    """A flax module called without `train`, under the name `inner`."""

    inner: fnn.Module

    def __call__(self, *args, train=False):
        return self.inner(*args)


class _PortBare(torch.nn.Module):
    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    def forward(self, *args):
        return self.inner(*args)


def _adjacency(n_speakers=2):
    _, qmask, _, lengths = _conversations()
    adj = gcnet.window_adjacency(T, torch.from_numpy(lengths), 2, 2)
    return (adj.numpy(),
            gcnet.speaker_relation_adjacency(adj, torch.from_numpy(qmask), n_speakers).numpy())


def test_dense_rgcn_conv():
    _, adj_rel = _adjacency()
    check(_Bare(jax_gcnet.DenseRGCNConv(5, 4)), _PortBare(gcnet.DenseRGCNConv(6, 5, 4)),
          [_x(B, T, 6, seed=1), adj_rel])


def test_dense_graph_conv():
    adj, _ = _adjacency()
    check(_Bare(jax_gcnet.DenseGraphConv(5)), _PortBare(gcnet.DenseGraphConv(6, 5)),
          [_x(B, T, 6, seed=2), adj])


ATTENTION = {
    "dot": dict(mem_dim=6, cand_dim=6),
    "general": dict(mem_dim=6, cand_dim=5),
    "general2": dict(mem_dim=6, cand_dim=5),
    "concat": dict(mem_dim=6, cand_dim=5, alpha_dim=4),
}


@pytest.mark.parametrize("candidate", ["sequence", "single"])
@pytest.mark.parametrize("att_type", list(ATTENTION))
def test_matching_attention(att_type, candidate):
    kw = dict(ATTENTION[att_type], att_type=att_type)
    _, _, umask, _ = _conversations()
    cand = _x(B, 5, kw["cand_dim"], seed=4) if candidate == "sequence" else \
        _x(B, kw["cand_dim"], seed=4)
    check(_Bare(jax_gcnet.MatchingAttention(**kw)), _PortBare(gcnet.MatchingAttention(**kw)),
          [_x(B, T, kw["mem_dim"], seed=3), cand, umask])


def test_matching_attention_without_mask():
    kw = dict(mem_dim=6, cand_dim=5, att_type="general2")
    check(_Bare(jax_gcnet.MatchingAttention(**kw)), _PortBare(gcnet.MatchingAttention(**kw)),
          [_x(B, T, 6, seed=5), _x(B, T, 5, seed=6)])


MODELS = {
    # base, n_speakers, windows, time attention
    "lstm_two_speakers_window": dict(base_model="LSTM", n_speakers=2, window_past=2,
                                     window_future=1, time_attn=True),
    "lstm_one_speaker_unlimited": dict(base_model="LSTM", n_speakers=1, window_past=-1,
                                       window_future=-1, time_attn=False),
    "gru_two_speakers_unlimited": dict(base_model="GRU", n_speakers=2, window_past=-1,
                                       window_future=-1, time_attn=True),
}
SIZES = dict(adim=ADIM, tdim=TDIM, vdim=VDIM, D_e=5, graph_hidden_size=4, n_classes=4,
             dropout=0.0)


@pytest.mark.parametrize("form", list(MODELS))
def test_graph_model(form):
    """A padded batch (lengths 8, 5, 2 of T = 8); the registry's `gcnet`
    builds both the first time."""
    kw = {**SIZES, **MODELS[form]}
    if form == "lstm_two_speakers_window":
        jmodel, model = jax_build("gcnet", **kw), build_module("gcnet", **kw)
        assert type(jmodel) is jax_gcnet.GraphModel and type(model) is gcnet.GraphModel
    else:
        jmodel, model = jax_gcnet.GraphModel(**kw), gcnet.GraphModel(**kw)
    check(jmodel, model, list(_conversations(seed=7)),
          launches=[2] * (6 if kw["base_model"] == "LSTM" else 4))


def test_graph_network_through_the_registry():
    feats = _x(B, T, 10, seed=8)
    _, qmask, umask, lengths = _conversations()
    adj = gcnet.window_adjacency(T, torch.from_numpy(lengths), 1, 1)
    adj_t = gcnet.temporal_relation_adjacency(adj).numpy()
    valid = np.arange(T)[None] < lengths[:, None]
    kw = dict(num_features=10, num_relations=3, time_attention=True, hidden_size=4, dropout=0.0)
    check(jax_build("graph_network", **kw), build_module("graph_network", **kw),
          [feats, adj_t, adj.numpy(), valid, umask], launches=[2, 2])


def test_valid_outputs_invariant_to_pad_length():
    """mmtpu's own invariant (tests/test_gcnet.py): more padding after the
    conversations changes no valid position's logits."""
    torch.manual_seed(0)
    model = gcnet.GraphModel(**{**SIZES, **MODELS["lstm_two_speakers_window"]}).eval()
    feats, qmask, umask, lengths = (torch.from_numpy(a) for a in _conversations(seed=9))
    pad = 5
    with torch.no_grad():
        logits, _, _ = model(feats, qmask, umask, lengths)
        padded, _, _ = model(torch.nn.functional.pad(feats, (0, 0, 0, pad)),
                             torch.nn.functional.pad(qmask, (0, pad)),
                             torch.nn.functional.pad(umask, (0, pad)), lengths)
    for b, n in enumerate(lengths.tolist()):
        torch.testing.assert_close(padded[b, :n], logits[b, :n], rtol=1e-5, atol=1e-5)


def test_losses():
    g = np.random.default_rng(11)
    D = ADIM + TDIM + VDIM
    recon, target = _x(B, T, D, seed=12), _x(B, T, D, seed=13)
    present = g.integers(0, 2, (B, T, 3)).astype(np.float32)
    _, _, umask, _ = _conversations()
    logits, labels = _x(B, T, 4, seed=14), g.integers(0, 4, (B, T)).astype(np.int32)
    pred, reg = _x(B, T, seed=15), _x(B, T, seed=16)
    t = torch.from_numpy
    pairs = [
        (gcnet_loss.masked_recon_loss(t(recon), t(target), t(present), t(umask), ADIM, TDIM,
                                      VDIM),
         jax_loss.masked_recon_loss(recon, target, present, umask, ADIM, TDIM, VDIM)),
        (gcnet_loss.masked_ce_loss(t(logits), t(labels), t(umask)),
         jax_loss.masked_ce_loss(logits, labels, umask)),
        (gcnet_loss.masked_ce_loss(t(logits.reshape(-1, 4)), t(labels.reshape(-1)),
                                   t(umask.reshape(-1))),
         jax_loss.masked_ce_loss(logits.reshape(-1, 4), labels.reshape(-1), umask.reshape(-1))),
        (gcnet_loss.masked_mse_loss(t(pred), t(reg), t(umask)),
         jax_loss.masked_mse_loss(pred, reg, umask)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)


def test_refused_options():
    """mmtpu raises these at the first call, the port at construction."""
    feats, qmask, umask, lengths = (jnp.asarray(a) for a in _conversations())
    with pytest.raises(ValueError, match="n_speakers must be <= 2"):
        jax_gcnet.GraphModel(**{**SIZES, **MODELS["lstm_two_speakers_window"],
                                "n_speakers": 3}).init(jax.random.PRNGKey(0), feats, qmask,
                                                       umask, lengths)
    with pytest.raises(ValueError, match="n_speakers must be <= 2"):
        gcnet.GraphModel(**{**SIZES, **MODELS["lstm_two_speakers_window"], "n_speakers": 3})
    mem = jnp.zeros((B, T, 6))
    for kw, msg in ((dict(mem_dim=6, cand_dim=5, att_type="concat"), "alpha_dim"),
                    (dict(mem_dim=6, cand_dim=5, att_type="dot"), "mem_dim must equal"),
                    (dict(mem_dim=6, cand_dim=6, att_type="other"), "unknown att_type")):
        with pytest.raises(ValueError, match=msg):
            jax_gcnet.MatchingAttention(**kw).init(jax.random.PRNGKey(0), mem,
                                                   jnp.zeros((B, kw["cand_dim"])))
        with pytest.raises(ValueError, match=msg):
            gcnet.MatchingAttention(**kw)


def test_full_tree_converts_without_leftovers():
    kw = {**SIZES, **MODELS["lstm_two_speakers_window"]}
    args = [jnp.asarray(a) for a in _conversations()]
    params = jax.tree_util.tree_map(
        np.asarray, jax.jit(jax_gcnet.GraphModel(**kw).init)(jax.random.PRNGKey(0), *args))
    model = gcnet.GraphModel(**kw)
    state = from_jax_variables(params["params"], target=model, require_all=True)
    assert set(state) == set(model.state_dict())
    assert len(state) == len(jax.tree_util.tree_leaves(params["params"]))


@pytest.mark.parametrize("name", ["graph_model", "matching_attention"])
def test_registry_names(name):
    kw = {**SIZES, **MODELS["lstm_one_speaker_unlimited"]} if name == "graph_model" else \
        dict(mem_dim=6, cand_dim=6, att_type="dot")
    assert type(jax_build(name, **kw)).__name__ == type(build_module(name, **kw)).__name__
