"""The port's federated parameter codec (`mmtpu_torch/federated`) against
mmtpu's, on the CPU: for the same tree both packages' `serialize_params`
give the same base64 string (the port's pure-Python msgpack writer gives
`flax.serialization.to_bytes` byte for byte), and each package's
`deserialize_params` restores the other's string exactly. The trees are a
small model's initial parameters and trees built to reach every msgpack
format the writer has: the smallest int, str, bin, array, map and ext
forms at their boundaries, numpy scalars, complex numbers, lists and
tuples (which flax writes as maps keyed by index)."""

import numpy as np
import pytest
import torch
from _torch_threads import few_threads  # noqa: E402,F401 — in-process comparisons only


def _model_params():
    import jax

    from mmtpu.models import build_module

    model = build_module("monomodal_encoder",
                         encoder=build_module("fcencoder", input_dim=8, layers=[16, 8],
                                              dropout=0.0),
                         output_dim=8, num_classes=4)
    variables = model.init({"params": jax.random.PRNGKey(0)}, np.zeros((2, 8), np.float32))
    return jax.tree_util.tree_map(np.asarray, {"params": dict(variables["params"])})


INTS = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1,
        -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63]


def _format_tree():
    rng = np.random.default_rng(0)
    return {
        "ints": {str(i): v for i, v in enumerate(INTS)},
        "floats": [0.0, -1.5, 1e300, float("inf")],
        "strings": ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "é" * 40000],
        "bytes": [b"", b"x" * 255, b"y" * 256, b"z" * 70000],
        "flags": (True, False, None),
        "scalars": [np.float32(1.5), np.int64(-3), np.bool_(True), np.uint8(7)],
        "complex": complex(1.0, -2.0),
        "arrays": {dt: (rng.normal(size=(3, 5)) * 10).astype(dt)
                   for dt in ("float32", "float64", "float16", "int8", "int32", "uint8", "bool")},
        "shapes": [np.zeros(()), np.zeros((0, 4), np.float32), np.ones((1,), np.int16),
                   np.arange(70000, dtype=np.float32)],
        "wide": {f"k{i}": np.float32(i) for i in range(20)},
        "long": list(range(20)),
        "huge_map": {str(i): i for i in range(70000)},
    }


TREES = {"model": _model_params, "formats": _format_tree}


def _assert_equal(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want)
        for k in want:
            _assert_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_equal(g, w)
    elif isinstance(want, (np.ndarray, np.generic)):
        got = np.asarray(got)
        assert got.dtype == np.asarray(want).dtype and got.shape == np.shape(want)
        np.testing.assert_array_equal(got, want)
    else:
        assert type(got) is type(want) and got == want


@pytest.mark.parametrize("name", list(TREES))
def test_same_string_as_mmtpu(name):
    from flax import serialization

    from mmtpu.federated import serialize_params as jax_serialize

    from mmtpu_torch.checkpoints.msgpack import to_bytes
    from mmtpu_torch.federated import serialize_params

    tree = TREES[name]()
    assert to_bytes(tree) == serialization.to_bytes(tree)
    assert serialize_params(tree) == jax_serialize(tree)


@pytest.mark.parametrize("name", list(TREES))
def test_each_package_decodes_the_others_string(name):
    from mmtpu.federated import deserialize_params as jax_deserialize
    from mmtpu.federated import serialize_params as jax_serialize

    from mmtpu_torch.federated import deserialize_params, serialize_params

    tree = TREES[name]()
    _assert_equal(deserialize_params(jax_serialize(tree), tree), tree)
    _assert_equal(jax_deserialize(serialize_params(tree), tree), tree)


def test_tensor_trees_encode_as_their_arrays():
    """A tree of CPU tensors (a port model's parameters) gives the string of
    the same tree of numpy arrays, and decodes into tensors on the target's
    device."""
    from mmtpu_torch.federated import deserialize_params, serialize_params

    model = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.ReLU(), torch.nn.Linear(3, 2))
    tensors = {k: v.detach() for k, v in model.state_dict().items()}
    arrays = {k: v.numpy() for k, v in tensors.items()}
    encoded = serialize_params(tensors)
    assert encoded == serialize_params(arrays)
    back = deserialize_params(encoded, {k: torch.zeros_like(v) for k, v in tensors.items()})
    for k, v in tensors.items():
        assert isinstance(back[k], torch.Tensor) and torch.equal(back[k], v)
    with pytest.raises(ValueError, match="not present in state dict"):
        deserialize_params(encoded, {**arrays, "extra": np.zeros(1)})
