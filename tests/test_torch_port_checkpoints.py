"""The port's checkpoint readers against mmtpu's, on the CPU, on files the
tests write themselves (no reference weights are in the repository):

- reference-layout `.pth` files of an MNISTImage encoder at the shipped
  widths (32/64 channels, `net.5` 3136→64; 30 tensors, built as a plain dict
  of tensors from a numpy seed): a bare state dict, a `model_state_dict`
  wrapper, a `module.` prefix, a wrapper that also pickles reference classes
  from a temporary `models.avmnist` / `config.experiment` module removed
  before loading (the stub-module unpickler), and a whole pickled module.
  The port's loaded encoder holds the file's tensors byte for byte, equals
  a functional replay of the reference module, and equals mmtpu's
  `load_torch_checkpoint` result on the same input (1e-5); `trusted=False`
  refuses the pickled classes in both packages;
- `nn.LSTM` keys into the fused `LSTMEncoder` (the reference's layout: two
  biases, `weight_hh` transposed); bidirectional weights the automatic
  mapping cannot tell apart raise in both packages; a tensor the file lacks
  keeps its initial value in both and is reported;
- mmtpu's own `.ckpt` files (`save_encoder` of a ResNet18 encoder,
  `save_checkpoint` and `save_rolling` of an AVMNIST with MNIST encoders,
  `LSTMEncoder` across its two backends through `adapt_lstm_layout`) load
  into the port with mmtpu's forward (1e-5);
- the msgpack decoder against `flax.serialization.msgpack_restore`, and the
  candidate order of `resolve_checkpoint_path`.
"""

import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import serialization
from torch import nn

from mmtpu.checkpoints import manager as jax_manager
from mmtpu.checkpoints.torch_interop import load_torch_checkpoint as jax_load_torch
from mmtpu.models.registry import build_module as jax_build_module
from mmtpu_torch.checkpoints import (
    from_jax_variables,
    load_encoder_checkpoint,
    resolve_checkpoint_path,
)
from mmtpu_torch.checkpoints.msgpack import msgpack_restore
from mmtpu_torch.checkpoints.torch_interop import as_state_dict, read_object
from mmtpu_torch.models import build_module
from _torch_threads import few_threads  # noqa: E402,F401 — in-process comparisons only

TOL = 1e-5
ARGS = [(1, 32), (32, 32), (32, 64), (64, 64)]
NAMES = ("conv_block_one_one_args", "conv_block_one_two_args", "conv_block_two_one_args",
         "conv_block_two_two_args")


def _mnist_kwargs(hidden=64):
    return {**{n: {"conv_one_in": i, "conv_one_out": o} for n, (i, o) in zip(NAMES, ARGS)},
            "hidden_dim": hidden}


def reference_state(seed=0):
    """A reference MNISTImage state dict (Sequential net.0 … net.5), as a
    plain dict of tensors from a numpy seed."""
    g = np.random.default_rng(seed)
    sd = {}
    for slot, convs in ((0, ARGS[:2]), (2, ARGS[2:])):
        for which, (cin, cout) in zip(("one", "two"), convs):
            conv, bn = f"net.{slot}.conv_{which}", f"net.{slot}.batch_norm_{which}"
            sd[f"{conv}.weight"] = g.normal(size=(cout, cin, 3, 3)) / np.sqrt(9 * cin)
            sd[f"{conv}.bias"] = 0.1 * g.normal(size=cout)
            sd[f"{bn}.weight"] = 1 + 0.1 * g.normal(size=cout)
            sd[f"{bn}.bias"] = 0.1 * g.normal(size=cout)
            sd[f"{bn}.running_mean"] = 0.1 * g.normal(size=cout)
            sd[f"{bn}.running_var"] = g.uniform(0.5, 1.5, size=cout)
            sd[f"{bn}.num_batches_tracked"] = np.asarray(7)
    sd["net.5.weight"] = g.normal(size=(64, 3136)) / 56.0
    sd["net.5.bias"] = 0.1 * g.normal(size=64)
    return {k: torch.from_numpy(np.asarray(v, np.int64 if "num_batches" in k else np.float32))
            for k, v in sd.items()}


def replay(sd, x_nchw):
    """The reference MNISTImage's eval forward, functionally."""
    def conv_bn(x, conv, bn):
        x = F.conv2d(x, sd[f"{conv}.weight"], sd[f"{conv}.bias"], padding=1)
        x = F.batch_norm(x, sd[f"{bn}.running_mean"], sd[f"{bn}.running_var"],
                         sd[f"{bn}.weight"], sd[f"{bn}.bias"], training=False, eps=1e-5)
        return F.relu(x)

    x = conv_bn(x_nchw, "net.0.conv_one", "net.0.batch_norm_one")
    x = F.max_pool2d(conv_bn(x, "net.0.conv_two", "net.0.batch_norm_two"), 2)
    x = conv_bn(x, "net.2.conv_one", "net.2.batch_norm_one")
    x = F.max_pool2d(conv_bn(x, "net.2.conv_two", "net.2.batch_norm_two"), 2)
    return F.linear(x.flatten(1), sd["net.5.weight"], sd["net.5.bias"])


def _reference_classes():
    """Reference-like classes in temporary `models.avmnist` and
    `config.experiment` modules (the caller removes them)."""
    models, avmnist = types.ModuleType("models"), types.ModuleType("models.avmnist")
    config, experiment = types.ModuleType("config"), types.ModuleType("config.experiment")
    models.avmnist, config.experiment = avmnist, experiment

    class ConvBlock(nn.Module):
        def __init__(self, cin, cout):
            super().__init__()
            self.conv_one = nn.Conv2d(cin[0], cin[1], 3, padding=1)
            self.batch_norm_one = nn.BatchNorm2d(cin[1])
            self.conv_two = nn.Conv2d(cout[0], cout[1], 3, padding=1)
            self.batch_norm_two = nn.BatchNorm2d(cout[1])

    class MNISTImage(nn.Module):
        def __init__(self):
            super().__init__()
            self.net = nn.Sequential(ConvBlock(*ARGS[:2]), nn.MaxPool2d(2),
                                     ConvBlock(*ARGS[2:]), nn.MaxPool2d(2), nn.Flatten(),
                                     nn.Linear(3136, 64))

    class ExperimentConfig:
        def __init__(self):
            self.name = "shipped"

    for mod, cls in ((avmnist, ConvBlock), (avmnist, MNISTImage), (experiment, ExperimentConfig)):
        cls.__module__, cls.__qualname__ = mod.__name__, cls.__name__
        setattr(mod, cls.__name__, cls)
    return {"models": models, "models.avmnist": avmnist, "config": config,
            "config.experiment": experiment}


FORMATS = ("bare", "model_state_dict", "module_prefix", "pickled_classes", "whole_module")


@pytest.fixture(scope="module")
def reference_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("reference")
    sd = reference_state()
    paths = {f: root / f"{f}.pth" for f in FORMATS}
    torch.save(sd, paths["bare"])
    torch.save({"model_state_dict": sd, "epoch": 3}, paths["model_state_dict"])
    torch.save({"model_state_dict": {f"module.{k}": v for k, v in sd.items()}},
               paths["module_prefix"])
    mods = _reference_classes()
    sys.modules.update(mods)
    try:
        module = mods["models.avmnist"].MNISTImage()
        module.load_state_dict(sd)
        torch.save({"model_state_dict": sd, "config": mods["config.experiment"].ExperimentConfig(),
                    "path": __import__("pathlib").PurePosixPath("/x")}, paths["pickled_classes"])
        torch.save(module, paths["whole_module"])
    finally:
        for name in mods:
            sys.modules.pop(name, None)
    return sd, paths


def _jax_encoder():
    jm = jax_build_module("mnist_image", **_mnist_kwargs())
    v = jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((2, 28, 28, 1)), train=False)
    return jm, v


def _image(seed=3, B=4):
    return np.random.default_rng(seed).normal(size=(B, 28, 28, 1)).astype(np.float32)


@pytest.mark.parametrize("fmt", FORMATS)
def test_reference_pth_loads_byte_exact_and_replays(reference_files, fmt):
    sd, paths = reference_files
    enc = build_module("mnist_image", **_mnist_kwargs())
    report = load_encoder_checkpoint(paths[fmt], enc)
    assert report.format == "torch" and report.kept == [] and report.fallback == {}
    got = enc.state_dict()
    assert set(got) == set(sd)
    for k, v in sd.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    x = _image()
    with torch.no_grad():
        ours = enc.eval()(torch.from_numpy(x))
        theirs = replay(sd, torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    np.testing.assert_allclose(ours.numpy(), theirs.numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("fmt", FORMATS[:4])
def test_reference_pth_matches_mmtpus_reader(reference_files, fmt):
    _, paths = reference_files
    jm, v = _jax_encoder()
    params, stats = jax_load_torch(paths[fmt], v["params"], v["batch_stats"])
    x = _image(5)
    want = np.asarray(jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                               train=False))
    enc = build_module("mnist_image", **_mnist_kwargs())
    load_encoder_checkpoint(paths[fmt], enc)
    with torch.no_grad():
        ours = enc.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, want, rtol=TOL, atol=TOL)


def test_whole_pickled_module_is_read_by_the_port_only(reference_files):
    """A whole pickled module: the port takes its parameters and buffers;
    mmtpu's reader walks dicts only and finds no tensor in it."""
    from mmtpu.checkpoints.torch_interop import _load_state_dict as jax_read

    sd, paths = reference_files
    assert jax_read(paths["whole_module"]) == {}
    got = as_state_dict(read_object(paths["whole_module"])[0])
    assert set(got) == set(sd) and all(torch.equal(got[k], sd[k]) for k in sd)


@pytest.mark.parametrize("fmt", ["pickled_classes", "whole_module"])
def test_untrusted_pickles_are_refused_in_both(reference_files, fmt):
    from mmtpu.checkpoints.torch_interop import _load_state_dict as jax_read

    _, paths = reference_files
    with pytest.raises(ValueError, match="trusted=False"):
        jax_read(paths[fmt], trusted=False)
    with pytest.raises(ValueError, match="trusted=False"):
        load_encoder_checkpoint(paths[fmt], build_module("mnist_image", **_mnist_kwargs()),
                                trusted=False)
    assert "models" not in sys.modules and "config.experiment" not in sys.modules


def test_missing_tensor_keeps_its_initial_value_in_both(reference_files, tmp_path):
    sd, _ = reference_files
    path = tmp_path / "partial.pth"
    torch.save({k: v for k, v in sd.items() if k != "net.5.bias"}, path)
    enc = build_module("mnist_image", **_mnist_kwargs())
    before = enc.net[5].bias.detach().clone()
    report = load_encoder_checkpoint(path, enc)
    assert report.kept == ["net.5.bias"] and torch.equal(enc.net[5].bias, before)
    assert torch.equal(enc.net[5].weight, sd["net.5.weight"])
    _, v = _jax_encoder()
    params, _ = jax_load_torch(path, v["params"], v["batch_stats"])
    np.testing.assert_array_equal(np.asarray(params["fc"]["bias"]),
                                  np.asarray(v["params"]["fc"]["bias"]))


# -- nn.LSTM keys into the fused LSTMEncoder --------------------------------------

I, H, B, T = 10, 16, 4, 12


class TorchLSTMEncoder(nn.Module):
    """The reference's LSTMEncoder layout: nn.LSTM, an attention layer as
    Sequential(Linear, Tanh), a raw attention vector."""

    def __init__(self, rnn_name="rnn", bidirectional=False):
        super().__init__()
        torch.manual_seed(0)
        self.rnn_name = rnn_name
        setattr(self, rnn_name, nn.LSTM(I, H, batch_first=True, bidirectional=bidirectional))
        self.attention_vector_weight = nn.Parameter(torch.randn(H, 1) * 0.1)
        self.attention_layer = nn.Sequential(nn.Linear(H, H), nn.Tanh())

    def forward(self, x):
        out, _ = getattr(self, self.rnn_name)(x)
        scores = (self.attention_layer(out) @ self.attention_vector_weight).squeeze(-1)
        return (out * torch.softmax(scores, dim=-1).unsqueeze(-1)).sum(dim=1)


def test_lstm_keys_load_into_the_fused_encoder(tmp_path):
    ref = TorchLSTMEncoder().eval()
    path = tmp_path / "encoder_audio_best.pth"
    torch.save(ref.state_dict(), path)
    enc = build_module("lstmencoder", input_size=I, hidden_size=H, embd_method="attention")
    report = load_encoder_checkpoint(path, enc)
    assert report.kept == [] and report.fallback == {}
    sd = ref.state_dict()
    assert torch.equal(enc.wi.weight, sd["rnn.weight_ih_l0"])
    assert torch.equal(enc.wh, sd["rnn.weight_hh_l0"].t())
    assert torch.equal(enc.wi.bias, sd["rnn.bias_ih_l0"] + sd["rnn.bias_hh_l0"])
    assert torch.equal(enc.attention_layer.weight, sd["attention_layer.0.weight"])
    x = np.random.default_rng(3).normal(size=(B, T, I)).astype(np.float32)
    with torch.no_grad():
        ours = enc.eval()(torch.from_numpy(x)).numpy()
        theirs = ref(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, theirs, rtol=TOL, atol=TOL)
    jm = jax_build_module("lstmencoder", input_size=I, hidden_size=H, embd_method="attention")
    v = jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((2, T, I)), train=False)
    params = jax_load_torch(path, v["params"])
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x), train=False))
    np.testing.assert_allclose(ours, want, rtol=TOL, atol=TOL)


def test_bidirectional_weights_that_cannot_be_told_apart_raise_in_both(tmp_path):
    path = tmp_path / "bidirectional.pth"
    torch.save(TorchLSTMEncoder(rnn_name="lstm", bidirectional=True).state_dict(), path)
    enc = build_module("lstmencoder", input_size=I, hidden_size=H, embd_method="attention")
    with pytest.raises(ValueError, match="bidirectional"):
        load_encoder_checkpoint(path, enc)
    jm = jax_build_module("lstmencoder", input_size=I, hidden_size=H, embd_method="attention")
    v = jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((2, T, I)), train=False)
    with pytest.raises(ValueError, match="bidirectional"):
        jax_load_torch(path, v["params"])


# -- mmtpu's own .ckpt files ------------------------------------------------------


def _perturbed(variables, seed):
    g = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * g.normal(size=np.shape(a))).astype(np.float32)
        if np.asarray(a).dtype == np.float32 else np.asarray(a), variables)


def test_mmtpu_encoder_ckpt_loads_with_mmtpus_forward(tmp_path):
    from mmtpu_torch.models import ResNet18

    jm = jax_build_module("resnet18", hidden_dim=8)
    x = np.random.default_rng(0).normal(size=(2, 32, 94, 1)).astype(np.float32)
    v = _perturbed(jm.init(jax.random.PRNGKey(1), jnp.asarray(x), train=False), 2)
    path = jax_manager.CheckpointManager(tmp_path).save_encoder(v["params"], "audio",
                                                                v["batch_stats"])
    assert path.name == "encoder_audio_best.ckpt"
    enc = ResNet18(hidden_dim=8)
    report = load_encoder_checkpoint(tmp_path / "encoder_audio_best.pth", enc)
    assert report.format == "mmtpu" and report.path == str(path) and report.kept == []
    with torch.no_grad():
        ours = enc.eval()(torch.from_numpy(x)).numpy()
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    np.testing.assert_allclose(ours, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("which", ["best", "last"])
def test_mmtpu_training_ckpt_loads_the_whole_model(tmp_path, which):
    """save_checkpoint's best.ckpt and save_rolling's last.ckpt (opt_state,
    step and the resume_meta string beside the variables) of an AVMNIST with
    MNIST encoders, whose `fc` kernels are permuted on the way."""
    import optax

    from mmtpu.config.spec import ModuleSpec as JaxSpec
    from mmtpu.train.state import TrainState as JaxTrainState

    from mmtpu_torch.config.spec import specs_from_dicts

    narrow = {n: {"conv_one_in": i, "conv_one_out": o}
              for n, (i, o) in zip(NAMES, [(1, 4), (4, 4), (4, 8), (8, 8)])}
    spec = {"audio_encoder": {"__module_spec__": "mnist_audio", **narrow, "hidden_dim": 6},
            "image_encoder": {"__module_spec__": "mnist_image", **narrow, "hidden_dim": 6},
            "hidden_dim": 8}
    jm = jax_build_module("avmnist", **{k: JaxSpec(v.pop("__module_spec__"), v)
                                        if isinstance(v, dict) else v
                                        for k, v in __import__("copy").deepcopy(spec).items()})
    g = np.random.default_rng(4)
    A = g.normal(size=(3, 32, 94)).astype(np.float32)
    Im = g.normal(size=(3, 28, 28, 1)).astype(np.float32)
    v = _perturbed(jm.init(jax.random.PRNGKey(0), jnp.asarray(A), jnp.asarray(Im),
                           train=False), 5)
    state = JaxTrainState.create(apply_fn=jm.apply, params=v["params"],
                                 batch_stats=v["batch_stats"], tx=optax.adam(1e-3))
    mgr = jax_manager.CheckpointManager(tmp_path)
    if which == "best":
        mgr.save_checkpoint(state, epoch=2, metric_value=0.5)
    else:
        mgr.save_rolling(state, epoch=2, meta={"lr_scale": 0.5})
    pm = build_module("avmnist", **specs_from_dicts(spec))
    report = load_encoder_checkpoint(tmp_path / f"{which}.pth", pm)
    assert report.format == "mmtpu" and report.path.endswith(f"{which}.ckpt")
    with torch.no_grad():
        ours = pm.eval()(torch.from_numpy(A), torch.from_numpy(Im)).numpy()
    want = np.asarray(jm.apply(v, jnp.asarray(A), jnp.asarray(Im), train=False))
    np.testing.assert_allclose(ours, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("saved,loaded", [("fused", "rnn"), ("rnn", "fused"),
                                          ("fused", "fused")])
def test_mmtpu_lstm_ckpt_loads_across_backends(tmp_path, saved, loaded):
    jm = jax_build_module("lstmencoder", input_size=I, hidden_size=H, embd_method="attention",
                          backend=saved)
    x = np.random.default_rng(6).normal(size=(B, T, I)).astype(np.float32)
    v = _perturbed(jm.init(jax.random.PRNGKey(2), jnp.asarray(x), train=False), 7)
    jax_manager.CheckpointManager(tmp_path).save_encoder(v["params"], "audio")
    enc = build_module("lstmencoder", input_size=I, hidden_size=H, embd_method="attention",
                       backend=loaded)
    report = load_encoder_checkpoint(tmp_path / "encoder_audio_best.ckpt", enc)
    assert report.kept == []
    with torch.no_grad():
        ours = enc.eval()(torch.from_numpy(x)).numpy()
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    np.testing.assert_allclose(ours, want, rtol=TOL, atol=TOL)


# -- the msgpack decoder and path resolution ----------------------------------------

TREES = {
    "float32": {"params": {"a": {"kernel": np.arange(12, dtype=np.float32).reshape(3, 4)},
                           "b": np.float32(-1.5) * np.ones((2,), np.float32)}},
    "ints_bools": {"i32": np.arange(-3, 3, dtype=np.int32), "i64": np.array([2**40], np.int64),
                   "u8": np.arange(4, dtype=np.uint8), "mask": np.array([[True, False]]),
                   "step": 12, "neg": -7, "big": 2**40},
    "str_bytes": {"resume_meta": '{"epoch": 3, "lr_scale": 0.5}', "blob": b"\x00\xff",
                  "nested": {"empty": {}, "none": None, "f": 0.25, "t": True, "l": [1, "x"]}},
    "scalars_shapes": {"scalar": np.float32(3.0), "zero_d": np.array(2.5), "empty":
                       np.zeros((0, 3), np.float32), "long": "y" * 70000,
                       "wide": {str(i): np.full((3,), i, np.int16) for i in range(20)}},
}


@pytest.mark.parametrize("name", sorted(TREES))
def test_msgpack_decoder_matches_flax(name):
    data = serialization.msgpack_serialize(TREES[name])
    want, got = serialization.msgpack_restore(data), msgpack_restore(data)

    def same(a, b, path):
        assert type(a) is type(b) or (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)), \
            (path, type(a), type(b))
        if isinstance(a, dict):
            assert list(a) == list(b), path
            for k in a:
                same(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, (np.ndarray, np.generic)):
            assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), path
        else:
            assert a == b, path

    same(want, got, "")


@pytest.mark.parametrize("layout", ["handoff", "training"])
def test_ports_own_files_load_strictly(tmp_path, layout):
    """The port's own files (the encoder handoff, a training checkpoint's
    "model") load with strict=True: exact where they fit the target, an
    error where they do not."""
    from mmtpu_torch.checkpoints.manager import CheckpointManager

    torch.manual_seed(3)
    src = build_module("mnist_image", **_mnist_kwargs())
    sd = {k: v.detach().clone() for k, v in src.state_dict().items()}
    if layout == "handoff":
        path = CheckpointManager(tmp_path).save_encoder(src, "image")
    else:
        path = tmp_path / "best.pth"
        torch.save({"model": sd, "optimizer": {}, "step": 3}, path)
    enc = build_module("mnist_image", **_mnist_kwargs())
    report = load_encoder_checkpoint(path, enc)
    assert report.format == "torch" and report.kept == [] and report.fallback == {}
    got = enc.state_dict()
    assert set(got) == set(sd) and all(torch.equal(got[k], v) for k, v in sd.items())
    with pytest.raises(RuntimeError, match="size mismatch"):
        load_encoder_checkpoint(path, build_module("mnist_image", **_mnist_kwargs(hidden=32)))


def test_training_checkpoint_that_does_not_fit_raises(tmp_path):
    """A training checkpoint missing a tensor, with one the model lacks:
    nothing is kept at its initial value, nothing dropped."""
    sd = dict(build_module("mnist_image", **_mnist_kwargs()).state_dict())
    sd["extra.weight"] = sd.pop("net.5.bias")
    path = tmp_path / "best.pth"
    torch.save({"model": sd, "optimizer": {}, "step": 1}, path)
    with pytest.raises(RuntimeError, match=r"(?s)Missing key.*net\.5\.bias.*extra\.weight"):
        load_encoder_checkpoint(path, build_module("mnist_image", **_mnist_kwargs()))


def test_resolve_checkpoint_path_order(tmp_path):
    (tmp_path / "a.ckpt").write_bytes(b"")
    (tmp_path / "b.pth").write_bytes(b"")
    (tmp_path / "c.pth").write_bytes(b"")
    (tmp_path / "c.ckpt").write_bytes(b"")
    assert resolve_checkpoint_path(tmp_path / "a.pth") == tmp_path / "a.ckpt"
    assert resolve_checkpoint_path(tmp_path / "b.ckpt") == tmp_path / "b.pth"
    assert resolve_checkpoint_path(tmp_path / "c.pth") == tmp_path / "c.pth"
    assert resolve_checkpoint_path(tmp_path / "c.ckpt") == tmp_path / "c.ckpt"
    with pytest.raises(FileNotFoundError):
        resolve_checkpoint_path(tmp_path / "d.pth")
    with pytest.raises(FileNotFoundError):
        load_encoder_checkpoint(tmp_path / "d.ckpt", build_module("mnist_image",
                                                                  **_mnist_kwargs()))


def test_from_jax_variables_permutes_the_mnist_flatten_once():
    """mmtpu's NHWC flatten → the port's NCHW one, at the allowlisted
    geometry without a target and at the target's own with one; a width
    no known flatten gives raises without a target."""
    jm, v = _jax_encoder()
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    kernel = params["fc"]["kernel"]  # (H·W·C, out)
    want = kernel.T.reshape(64, 7, 7, 64).transpose(0, 3, 1, 2).reshape(64, 3136)
    for target in (None, build_module("mnist_image", **_mnist_kwargs())):
        state = from_jax_variables(params, jax.tree_util.tree_map(np.asarray, v["batch_stats"]),
                                   target=target)
        np.testing.assert_array_equal(state["net.5.weight"].numpy(), want)
    narrow = {n: {"conv_one_in": i, "conv_one_out": o}
              for n, (i, o) in zip(NAMES, [(1, 2), (2, 2), (2, 3), (3, 3)])}
    small = jax_build_module("mnist_image", **narrow, hidden_dim=4)
    sv = small.init(jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 1)), train=False)
    with pytest.raises(ValueError, match="no known conv flatten"):
        from_jax_variables(jax.tree_util.tree_map(np.asarray, sv["params"]))
    target = build_module("mnist_image", **narrow, hidden_dim=4)
    assert target.flatten_chw == (3, 7, 7)
    from_jax_variables(jax.tree_util.tree_map(np.asarray, sv["params"]),
                       jax.tree_util.tree_map(np.asarray, sv["batch_stats"]), target=target)
