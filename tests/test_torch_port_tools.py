"""`mmtpu_torch/models/tools.py`'s network helpers against mmtpu's
`mmtpu/models/tools.py` (the family `tests/test_msa_extras.py:203-266`
exercises): `init_weights` / `init_net` drawn from a `torch.Generator`
against mmtpu's statistics and its choice of leaves (recurrent leaves
untouched, orthogonal QᵀQ = g²I), `get_norm_layer`'s layers against
mmtpu's on the same inputs and its error, `diagnose_network`'s number,
`extract_mid_features` by mmtpu's layer-path rule, and `Identity`."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from mmtpu.models import tools as J
from mmtpu.models.lstm import LSTMEncoder as JaxLSTMEncoder
from mmtpu_torch.models import tools as T
from mmtpu_torch.models.lstm import LSTMEncoder

RNG = jax.random.PRNGKey(0)
STAT_RTOL = 0.01  # a drawn std against mmtpu's over ~10^6 draws
NORM_TOL = 1e-4  # flax's batch variance is E[x²] - E[x]² in float32


class JaxNet(fnn.Module):  # tests/test_msa_extras.py's Net
    @fnn.compact
    def __call__(self, x, train=False):
        x = fnn.Conv(4, (3, 3), name="conv")(x)
        x = fnn.BatchNorm(use_running_average=not train, name="bn")(x)
        x = x.reshape((x.shape[0], -1))
        x = fnn.Dense(8, name="fc")(x)
        return fnn.Dense(2, name="head")(x)


class Net(nn.Module):
    """JaxNet in torch, flattening NHWC as flax does."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 4, 3, padding=1)
        self.bn = nn.BatchNorm2d(4)
        self.fc = nn.Linear(100, 8)
        self.head = nn.Linear(8, 2)

    def forward(self, x):
        x = self.bn(self.conv(x))
        return self.head(self.fc(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)))


def _net_pair():
    jnet = JaxNet()
    vs = jnet.init(RNG, jnp.ones((2, 5, 5, 3)))
    net = Net().eval()
    p, st = jax.tree_util.tree_map(np.asarray, vs["params"]), vs["batch_stats"]
    with torch.no_grad():
        net.conv.weight.copy_(torch.from_numpy(p["conv"]["kernel"].transpose(3, 2, 0, 1)))
        net.conv.bias.copy_(torch.from_numpy(p["conv"]["bias"]))
        net.bn.weight.copy_(torch.from_numpy(p["bn"]["scale"]))
        net.bn.bias.copy_(torch.from_numpy(p["bn"]["bias"]))
        net.bn.running_mean.copy_(torch.from_numpy(np.asarray(st["bn"]["mean"])))
        net.bn.running_var.copy_(torch.from_numpy(np.asarray(st["bn"]["var"])))
        for name in ("fc", "head"):
            getattr(net, name).weight.copy_(torch.from_numpy(p[name]["kernel"].T))
            getattr(net, name).bias.copy_(torch.from_numpy(p[name]["bias"]))
    return jnet, vs, net


@pytest.mark.parametrize("init_type,gain", [("normal", 0.5), ("xavier", 1.5),
                                            ("kaiming", 0.02)])
@pytest.mark.parametrize("layer", ["dense", "conv"])
def test_init_weights_draws_mmtpus_distribution(init_type, gain, layer):
    """A 2^20-element Linear (1024 → 1024) or Conv (32 → 64, 16x16 window)
    kernel redrawn by both packages: the same std, mean 0, bias 0."""
    if layer == "dense":
        jshape, port = (1024, 1024), nn.Linear(1024, 1024)
        params = {"layer": {"kernel": jnp.zeros(jshape), "bias": jnp.ones((1024,))}}
    else:
        jshape, port = (16, 16, 32, 64), nn.Conv2d(32, 64, 16)
        params = {"layer": {"kernel": jnp.zeros(jshape), "bias": jnp.ones((64,))}}
    want = np.asarray(J.init_weights(params, init_type, gain, seed=1)["layer"]["kernel"])
    got = T.init_weights(nn.Sequential(port), init_type, gain,
                         generator=torch.Generator().manual_seed(1))[0]
    w = got.weight.detach().numpy()
    assert w.size == want.size
    assert abs(w.std() - want.std()) <= STAT_RTOL * want.std()
    assert abs(w.mean()) <= 5 * want.std() / np.sqrt(w.size)
    assert not got.bias.any()
    np.testing.assert_array_equal(np.asarray(J.init_weights(params, init_type, gain,
                                                            seed=1)["layer"]["bias"]), 0)


@pytest.mark.parametrize("gain", [1.0, 2.0])
def test_init_weights_orthogonal_gives_g2_identity(gain):
    params = {"fc": {"kernel": jnp.zeros((72, 8)), "bias": jnp.zeros((8,))}}
    k = np.asarray(J.init_weights(params, "orthogonal", gain, seed=2)["fc"]["kernel"])
    np.testing.assert_allclose(k.T @ k, gain ** 2 * np.eye(8), atol=1e-4)
    w = T.init_weights(nn.Sequential(nn.Linear(72, 8)), "orthogonal", gain, seed=2)[0].weight
    w = w.detach().double().numpy()  # torch's (out, in): the rows orthogonal
    np.testing.assert_allclose(w @ w.T, gain ** 2 * np.eye(8), atol=1e-5)
    conv = T.init_weights(nn.Sequential(nn.Conv2d(3, 4, 3)), "orthogonal", gain,
                          seed=2)[0].weight.detach().double().reshape(4, -1).numpy()
    np.testing.assert_allclose(conv @ conv.T, gain ** 2 * np.eye(4), atol=1e-5)


def test_init_weights_touches_the_leaves_mmtpu_touches():
    """The Net: every kernel redrawn, biases zero, BatchNorm scales drawn
    around 1 and shifts zero, as mmtpu's; in an attention LSTMEncoder the
    same leaves redrawn in both (its attention layer) and the same left
    (`wi`, `wh`, the attention vector); an unknown kind raises in both."""
    jnet, vs, net = _net_pair()
    new = J.init_weights(vs["params"], "normal", 10.0, seed=4, batch_stats=vs["batch_stats"])
    before = {k: v.clone() for k, v in net.state_dict().items()}
    T.init_weights(net, "normal", 10.0, seed=4)
    after = net.state_dict()
    for name in ("conv", "fc", "head"):
        assert not np.array_equal(np.asarray(new[name]["kernel"]),
                                  np.asarray(vs["params"][name]["kernel"]))
        assert not torch.equal(after[f"{name}.weight"], before[f"{name}.weight"])
        np.testing.assert_array_equal(np.asarray(new[name]["bias"]), 0)
        assert not after[f"{name}.bias"].any()
    assert not np.array_equal(np.asarray(new["bn"]["scale"]), np.ones(4))
    assert not torch.equal(after["bn.weight"], torch.ones(4))
    np.testing.assert_array_equal(np.asarray(new["bn"]["bias"]), 0)
    assert not after["bn.bias"].any()
    for key in ("bn.running_mean", "bn.running_var"):
        assert torch.equal(after[key], before[key])

    jlstm = JaxLSTMEncoder(4, 4, embd_method="attention")
    jv = jlstm.init({"params": RNG, "dropout": RNG}, jnp.ones((2, 5, 4)))
    jnew = J.init_weights(jv["params"], "normal", 10.0, seed=4)
    want = {name for name in jv["params"] if any(
        not np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(
            jax.tree_util.tree_leaves(jnew[name]),
            jax.tree_util.tree_leaves(jv["params"][name])))}
    enc = LSTMEncoder(4, 4, embd_method="attention")
    before = {k: v.clone() for k, v in enc.state_dict().items()}
    T.init_weights(enc, "normal", 10.0, seed=4)
    got = {k.split(".")[0] for k, v in enc.state_dict().items() if not torch.equal(v, before[k])}
    assert got == want == {"attention_layer"}
    with pytest.raises(NotImplementedError, match="not implemented"):
        J.init_weights(vs["params"], "bogus")
    with pytest.raises(NotImplementedError, match="not implemented"):
        T.init_weights(Net(), "bogus")


def test_init_net_places_then_initialises():
    a = T.init_net(Net(), "xavier", 0.5, device="cpu", seed=7)
    b = T.init_weights(Net(), "xavier", 0.5, seed=7)
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(v, w), k
    params = {"fc": {"kernel": jnp.zeros((6, 3)), "bias": jnp.ones((3,))}}
    for x, y in zip(jax.tree_util.tree_leaves(J.init_net(params, "xavier", 0.5, seed=7)),
                    jax.tree_util.tree_leaves(J.init_weights(params, "xavier", 0.5, seed=7))):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("kind", ["batch", "instance", "layer", "none"])
@pytest.mark.parametrize("rank", [2, 4])
def test_get_norm_layer_matches_mmtpus_layers(kind, rank):
    """The same input (NHWC for mmtpu, NCHW for the port) through each
    layer, in training for BatchNorm (the batch statistics), with mmtpu's
    initial parameters."""
    shape = (3, 6) if rank == 2 else (3, 5, 4, 6)
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    layer = J.get_norm_layer(kind)()
    if kind == "batch":
        vs = layer.init(RNG, jnp.asarray(x), use_running_average=False)
        want, _ = layer.apply(vs, jnp.asarray(x), use_running_average=False,
                              mutable=["batch_stats"])
    else:
        want = layer.apply(layer.init(RNG, jnp.asarray(x)), jnp.asarray(x))
    xt = torch.from_numpy(x if rank == 2 else x.transpose(0, 3, 1, 2).copy())
    port = T.get_norm_layer(kind)(6).train()
    got = port(xt).detach().numpy()
    got = got if rank == 2 else got.transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, np.asarray(want), atol=NORM_TOL)
    if kind == "none":
        assert isinstance(port, T.Identity) and isinstance(J.get_norm_layer(kind)(), J.Identity)


def test_get_norm_layer_raises_on_mmtpus_unknown_names():
    for bogus in ("bogus", "group", ""):
        with pytest.raises(NotImplementedError, match="not found"):
            J.get_norm_layer(bogus)
        with pytest.raises(NotImplementedError, match="not found"):
            T.get_norm_layer(bogus)


def test_diagnose_network_gives_mmtpus_number():
    rng = np.random.default_rng(5)
    grads = {"a": rng.normal(size=(3,)), "b": {"c": rng.normal(size=(2, 4)),
                                             "d": rng.normal(size=(5,))}}
    want = J.diagnose_network(jax.tree_util.tree_map(jnp.asarray, grads))
    assert T.diagnose_network(jax.tree_util.tree_map(torch.from_numpy, grads)) == \
        pytest.approx(want, rel=1e-6)
    assert J.diagnose_network({"a": jnp.full((3,), -2.0), "b": {"c": jnp.full((2,), 4.0)}}) \
        == T.diagnose_network({"a": torch.full((3,), -2.0), "b": [torch.full((2,), 4.0)]}) == 3.0
    net = Net()
    net.head.weight.grad = torch.full_like(net.head.weight, -2.0)
    net.head.bias.grad = torch.full_like(net.head.bias, 4.0)
    assert T.diagnose_network(net) == J.diagnose_network({"w": jnp.full((2, 8), -2.0),
                                                          "b": jnp.full((2,), 4.0)}) == 3.0
    assert T.diagnose_network({}) == J.diagnose_network({}) == 0.0


def test_extract_mid_features_follows_mmtpus_layer_paths():
    jnet, vs, net = _net_pair()
    x = np.random.default_rng(1).normal(size=(2, 5, 5, 3)).astype(np.float32)
    want = J.extract_mid_features(jnet, vs, [jnp.asarray(x)], layers="conv, fc")
    got = T.extract_mid_features(net, [torch.from_numpy(x.transpose(0, 3, 1, 2).copy())],
                                 layers="conv, fc")
    np.testing.assert_allclose(got[0].detach().numpy().transpose(0, 2, 3, 1),
                               np.asarray(want[0]), atol=1e-5)
    np.testing.assert_allclose(got[1].detach().numpy(), np.asarray(want[1]), atol=1e-5)
    with pytest.raises(KeyError, match="not found"):
        J.extract_mid_features(jnet, vs, [jnp.asarray(x)], layers="nope")
    with pytest.raises(KeyError, match="not found"):
        T.extract_mid_features(net, [torch.zeros(2, 3, 5, 5)], layers="nope")
    # "net.fusion[0]": flax's child `fusion_0` where a module has it, else
    # the Sequential's slot 0
    seq = nn.Module()
    seq.net = nn.Module()
    seq.net.fusion = nn.Sequential(nn.Linear(3, 2), nn.ReLU())
    seq.forward = lambda t: seq.net.fusion(t)
    flat = nn.Module()
    flat.fusion_0 = nn.Linear(3, 2)
    flat.forward = lambda t: flat.fusion_0(t)
    t = torch.ones(1, 3)
    assert T.extract_mid_features(seq, [t], "net.fusion[0]")[0].shape == (1, 2)
    assert torch.equal(T.extract_mid_features(flat, [t], "fusion[0]")[0], flat.fusion_0(t))
    assert J._parse_layer_path("net.fusion[0]") == ["net", "fusion_0"]


def test_identity_returns_its_input():
    x = torch.randn(2, 3)
    assert T.Identity()(x, 1, k=2) is x
    assert J.Identity().apply({}, jnp.ones(2), 1).shape == (2,)
