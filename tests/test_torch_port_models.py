"""Port models (mmtpu_torch.models) against mmtpu's flax models, from the
same weights carried across by `from_jax_variables`.

Weights are flax initialisations with BatchNorm scale/shift and running
statistics perturbed from a numpy seed, so the eval-mode BN path is really
exercised. Inputs are NHWC numpy, fed to both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from mmtpu.models import avmnist as jax_avmnist
from mmtpu.models import resnet as jax_resnet
from mmtpu_torch.checkpoints import from_jax_variables, save_pth
from mmtpu_torch.models import AVMNIST, ResNetEncoder, build_module
from mmtpu_torch.models.resnet import BasicBlock, Bottleneck
from _torch_threads import few_threads  # noqa: E402,F401 — in-process comparisons only

TOL = 1e-4  # fp32 convolutions sum in different orders in XLA and PyTorch


def _perturb(variables, seed):
    """BN scale/bias, Dense biases and running stats drawn from a seed."""
    g = np.random.default_rng(seed)
    out = {}
    for col, tree in variables.items():
        flat = flatten_dict(jax.tree_util.tree_map(np.asarray, tree))
        for path, v in flat.items():
            leaf = path[-1]
            if leaf == "scale":
                v = (1.0 + 0.1 * g.normal(size=v.shape)).astype(np.float32)
            elif leaf in ("bias", "mean"):
                v = (0.1 * g.normal(size=v.shape)).astype(np.float32)
            elif leaf == "var":
                v = g.uniform(0.5, 1.5, size=v.shape).astype(np.float32)
            flat[path] = v
        out[col] = unflatten_dict(flat)
    return out


def _init(model, *inputs, seed=0):
    v = model.init({"params": jax.random.PRNGKey(seed)},
                   *[jnp.asarray(x) for x in inputs], train=False)
    return _perturb(dict(v), seed + 100)


def _carry(variables, port_model):
    """from_jax_variables into the port model; asserts every flax leaf
    became exactly one port tensor and every port tensor was filled."""
    state = from_jax_variables(
        variables["params"], variables.get("batch_stats"), target=port_model
    )
    n_leaves = len(jax.tree_util.tree_leaves(variables))
    n_carried = sum(1 for k in state if not k.endswith("num_batches_tracked"))
    assert n_carried == n_leaves
    port_model.load_state_dict(state, strict=True)
    return port_model.eval()


def _audio(n, seed=5):
    return np.random.default_rng(seed).normal(size=(n, 32, 94)).astype(np.float32)


def _image(n, seed=6):
    return np.random.default_rng(seed).normal(size=(n, 28, 28, 1)).astype(np.float32)


ENCODERS = {
    "basic_1111": (dict(block=jax_resnet.BasicBlock, layers=(1, 1, 1, 1), hidden_dim=16),
                   dict(block=BasicBlock, layers=(1, 1, 1, 1), hidden_dim=16)),
    "bottleneck_1111": (dict(block=jax_resnet.Bottleneck, layers=(1, 1, 1, 1), hidden_dim=16),
                        dict(block=Bottleneck, layers=(1, 1, 1, 1), hidden_dim=16)),
}


@pytest.mark.parametrize("name", sorted(ENCODERS))
@pytest.mark.parametrize("modality", ["audio", "image"])
def test_resnet_encoder_matches_flax(name, modality):
    jax_kw, port_kw = ENCODERS[name]
    x = _audio(3) if modality == "audio" else _image(3)
    jm = jax_resnet.ResNetEncoder(**jax_kw)
    v = _init(jm, x)
    pm = _carry(v, ResNetEncoder(**port_kw))
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_full_resnet18_matches_flax():
    x = _audio(2)
    jm = jax_resnet.ResNet18(hidden_dim=64)
    v = _init(jm, x)
    pm = _carry(v, build_module("resnet18", in_channels=1, hidden_dim=64))
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def _tiny_avmnist():
    jm = jax_avmnist.AVMNIST(
        audio_encoder=jax_resnet.ResNetEncoder(layers=(1, 1, 1, 1), hidden_dim=16),
        image_encoder=jax_resnet.ResNetEncoder(layers=(1, 1, 1, 1), hidden_dim=24),
        hidden_dim=32, dropout=0.5,
    )
    pm = AVMNIST(
        audio_encoder=ResNetEncoder(layers=(1, 1, 1, 1), hidden_dim=16),
        image_encoder=ResNetEncoder(layers=(1, 1, 1, 1), hidden_dim=24),
        hidden_dim=32, dropout=0.5,
    )
    return jm, pm


def test_avmnist_eval_matches_flax():
    a, i = _audio(4), _image(4)
    jm, pm = _tiny_avmnist()
    v = _init(jm, a, i)
    pm = _carry(v, pm)
    want = np.asarray(jm.apply(v, jnp.asarray(a), jnp.asarray(i), train=False))
    with torch.no_grad():
        got = pm(torch.from_numpy(a), torch.from_numpy(i)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    # a zeroed raw image still gives a non-zero image embedding (BN running stats)
    with torch.no_grad():
        emb = pm.image_encoder(torch.zeros(1, 28, 28, 1))
    assert emb.abs().max() > 0


def test_monomodal_encoder_matches_flax():
    x = _image(3)
    jm = jax_avmnist.MonomodalEncoder(
        encoder=jax_resnet.ResNetEncoder(layers=(1, 1, 1, 1), hidden_dim=24),
        output_dim=24, num_classes=10,
    )
    v = _init(jm, x)
    pm = _carry(v, build_module(
        "monomodal_encoder",
        encoder=ResNetEncoder(layers=(1, 1, 1, 1), hidden_dim=24),
        output_dim=24, num_classes=10,
    ))
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_seeded_init_is_reproducible():
    from mmtpu_torch.models import seeded_init

    def weights(seed):
        _, pm = _tiny_avmnist()
        return seeded_init(pm, seed).state_dict()

    a, b, c = weights(3), weights(3), weights(4)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert not torch.equal(a["fc_fusion.weight"], c["fc_fusion.weight"])
    assert torch.equal(a["audio_encoder.bn1.running_var"], torch.ones(64))


def test_avmnist_head_keys_are_reference_names():
    _, pm = _tiny_avmnist()
    keys = set(pm.state_dict())
    for k in ("fc_fusion.weight", "fc_intermediate.bias", "fc_out.weight",
              "audio_encoder.layer2.0.downsample.0.weight",
              "image_encoder.layer1.0.bn1.running_var"):
        assert k in keys


def test_from_jax_variables_raises_on_unmapped_and_unfilled():
    jm, pm = _tiny_avmnist()
    v = _init(jm, _audio(2), _image(2))
    params = dict(v["params"])
    params["extra"] = {"weird_leaf": np.zeros(3, np.float32)}
    with pytest.raises(ValueError, match="no torch counterpart"):
        from_jax_variables(params, v["batch_stats"])
    params = dict(v["params"])
    params.pop("fc_out")
    with pytest.raises(ValueError, match="unfilled target keys"):
        from_jax_variables(params, v["batch_stats"], target=pm)


def test_port_pth_loads_in_mmtpu(tmp_path):
    """A .pth the port writes is the reference layout mmtpu reads: every
    flax leaf is filled from it and the logits agree."""
    from mmtpu.checkpoints.manager import load_model_variables

    a, i = _audio(3), _image(3)
    jm, pm = _tiny_avmnist()
    v = _init(jm, a, i)
    pm = _carry(v, pm)
    path = save_pth(pm, tmp_path / "best.pth")

    other = _init(jm, a, i, seed=7)  # a different target: nothing may survive
    params, stats = load_model_variables(path, other["params"], other["batch_stats"])
    for col, tree in (("params", params), ("batch_stats", stats)):
        got = flatten_dict(jax.tree_util.tree_map(np.asarray, tree))
        want = flatten_dict(jax.tree_util.tree_map(np.asarray, v[col]))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{col}/{k}")
    logits = np.asarray(jm.apply({"params": params, "batch_stats": stats},
                                 jnp.asarray(a), jnp.asarray(i), train=False))
    with torch.no_grad():
        port = pm(torch.from_numpy(a), torch.from_numpy(i)).numpy()
    np.testing.assert_allclose(port, logits, rtol=TOL, atol=TOL)
