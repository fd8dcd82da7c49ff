"""flax's msgpack serialisation in plain Python, since the card's machine
has no `msgpack` package: the reader of mmtpu's `.ckpt` files
(`flax.serialization.msgpack_restore`), and `to_bytes`, the writer of a
nested mapping of arrays byte for byte as `flax.serialization.to_bytes`
writes it (the federated codec's format). The port writes no `.ckpt` file.

It decodes the msgpack types flax writes — nil, booleans, integers,
floats, str, bin, arrays (as lists) and maps (as dicts) — and flax's
extension types: 1, an ndarray packed as msgpack (shape, dtype name,
C-order buffer); 2, a complex number; 3, a numpy scalar packed as an
ndarray. Arrays above flax's 1 GiB chunk size, which flax stores as
`{"__msgpack_chunked_array__": True, "shape": …, "chunks": …}`, are joined
back. `str` and `bytes` leaves (mmtpu's `resume_meta`) stay as they are.
A bfloat16 array becomes float32 (numpy has no bfloat16; the widening is
exact). Every array is a writable copy.

The writer packs as msgpack-python's `packb(use_bin_type=True,
strict_types=True)` does under flax: every int, str, bin, array, map and
ext in its smallest format, Python floats as float64; flax's state dict
first (lists and tuples become maps keyed "0", "1", …), a numpy array
(or a CPU tensor) as extension 1, a numpy scalar as extension 3 (a 0-d
array), a complex number as extension 2; arrays above 1 GiB in flax's
chunks.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any, Tuple, Union

import numpy as np
import torch

_CHUNKED = "__msgpack_chunked_array__"


class MsgpackError(ValueError):
    """The bytes are not one complete msgpack object."""


class _Reader:
    def __init__(self, data: bytes) -> None:
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise MsgpackError("truncated msgpack data")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str) -> Any:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self, raw: bool) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F, raw)
        if 0x90 <= b <= 0x9F:
            return [self.obj(raw) for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F, raw)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])))
        if b in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self.ext(n)
        if b == 0xCA:
            return self.unpack(">f")
        if b == 0xCB:
            return self.unpack(">d")
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in ints:
            return self.unpack(ints[b])
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            return self.str(self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b]), raw)
        if b in (0xDC, 0xDD):
            return [self.obj(raw) for _ in range(self.unpack(">H" if b == 0xDC else ">I"))]
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"), raw)
        raise MsgpackError(f"byte 0x{b:02x} at {self.pos - 1} starts no msgpack object")

    def str(self, n: int, raw: bool) -> Union[str, bytes]:
        data = bytes(self.take(n))
        return data if raw else data.decode("utf-8")

    def map(self, n: int, raw: bool) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj(raw)
            out[k] = self.obj(raw)
        return out

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        data = bytes(self.take(n))
        if code == 1:
            return _ndarray(data)
        if code == 2:
            real, imag = unpackb(data)
            return complex(real, imag)
        if code == 3:
            return _ndarray(data)[()]
        raise MsgpackError(f"unknown msgpack extension type {code}")


def _dtype(name: Union[str, bytes]) -> Tuple[np.dtype, bool]:
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        return np.dtype(np.uint16), True
    return np.dtype(name), False


def _ndarray(data: bytes) -> np.ndarray:
    shape, name, buffer = unpackb(data, raw=True)
    dtype, bf16 = _dtype(name)
    arr = np.frombuffer(buffer, dtype=dtype).reshape(shape, order="C").copy()
    if bf16:
        arr = (arr.astype(np.uint32) << 16).view(np.float32)
    return arr


def unpackb(data: bytes, raw: bool = False) -> Any:
    """One msgpack object from `data` (maps become dicts, arrays lists);
    `raw=True` leaves str values as bytes, as msgpack's `raw` does."""
    reader = _Reader(data)
    out = reader.obj(raw)
    if reader.pos != len(reader.buf):
        raise MsgpackError(f"{len(reader.buf) - reader.pos} bytes after the msgpack object")
    return out


def _unchunk(tree: Any) -> Any:
    if isinstance(tree, dict):
        if tree.get(_CHUNKED) is True:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def msgpack_restore(data: bytes) -> Any:
    """The tree `flax.serialization.msgpack_restore` gives for `data`."""
    return _unchunk(unpackb(data))


_MAX_CHUNK = 2 ** 30


def _pack_uint_header(out: bytearray, n: int, small: Tuple[int, int], codes: Tuple[int, ...]
                      ) -> None:
    """A length header: fix form `small[0] | n` below `small[1]`, then the
    8-, 16- and 32-bit forms in `codes` (None where msgpack has none)."""
    if n < small[1]:
        out.append(small[0] | n)
        return
    for code, fmt, top in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise MsgpackError(f"length {n} is too long for msgpack")


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 0x80 or -0x20 <= v < 0:
        out += struct.pack(">b" if v < 0 else ">B", v)
        return
    forms = ((0xCC, ">B", 0, 0xFF), (0xCD, ">H", 0, 0xFFFF), (0xCE, ">I", 0, 0xFFFFFFFF),
             (0xCF, ">Q", 0, 2 ** 64 - 1)) if v > 0 else (
        (0xD0, ">b", -0x80, 0), (0xD1, ">h", -0x8000, 0), (0xD2, ">i", -2 ** 31, 0),
        (0xD3, ">q", -2 ** 63, 0))
    for code, fmt, lo, hi in forms:
        if lo <= v <= hi:
            out.append(code)
            out += struct.pack(fmt, v)
            return
    raise MsgpackError(f"integer {v} does not fit msgpack's 64 bits")


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        out.append(fixed[len(data)])
    else:
        _pack_uint_header(out, len(data), (0, 0), (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code)
    out += data


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    """flax's `_ndarray_to_bytes`: (shape, dtype name, C-order bytes)."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("Object and structured dtypes not supported for serialization of "
                         "ndarrays.")
    return packb([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def _pack(out: bytearray, obj: Any) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif type(obj) is int:
        _pack_int(out, obj)
    elif type(obj) is float:
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif type(obj) is str:
        data = obj.encode("utf-8")
        _pack_uint_header(out, len(data), (0xA0, 32), (0xD9, 0xDA, 0xDB))
        out += data
    elif type(obj) in (bytes, bytearray, memoryview):
        data = bytes(obj)
        _pack_uint_header(out, len(data), (0, 0), (0xC4, 0xC5, 0xC6))
        out += data
    elif type(obj) is list:
        _pack_uint_header(out, len(obj), (0x90, 16), (None, 0xDC, 0xDD))
        for v in obj:
            _pack(out, v)
    elif type(obj) is dict:
        _pack_uint_header(out, len(obj), (0x80, 16), (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    elif isinstance(obj, np.ndarray):
        _pack_ext(out, 1, _ndarray_bytes(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, 3, _ndarray_bytes(np.asarray(obj)))
    elif type(obj) is complex:
        _pack_ext(out, 2, packb([obj.real, obj.imag]))
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj: Any) -> bytes:
    """msgpack bytes of `obj` (None, bool, int, float, str, bytes, list,
    dict, and as flax's extensions numpy arrays, numpy scalars and complex
    numbers), as msgpack-python's `packb(obj, use_bin_type=True)` with
    flax's `default` writes them."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


def _state_dict(tree: Any) -> Any:
    """flax's `to_state_dict` of a tree of dicts, lists and tuples (string
    keys; a list or tuple becomes a map keyed by index), with arrays above
    1 GiB chunked and CPU tensors as numpy arrays."""
    if isinstance(tree, dict):
        keys = {str(k) for k in tree}
        if len(keys) != len(tree):
            raise ValueError(f"Dict keys do not have a unique string representation: {keys}")
        return {str(k): _state_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): _state_dict(v) for i, v in enumerate(tree)}
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().cpu().numpy()
    if isinstance(tree, np.ndarray) and tree.nbytes > _MAX_CHUNK:
        per = max(1, _MAX_CHUNK // tree.dtype.itemsize)
        flat = tree.reshape(-1)
        return {_CHUNKED: True, "shape": {str(i): n for i, n in enumerate(tree.shape)},
                "chunks": {str(j): flat[i:i + per]
                           for j, i in enumerate(range(0, flat.size, per))}}
    return tree


def to_bytes(tree: Any) -> bytes:
    """`flax.serialization.to_bytes(tree)` for a tree of dicts, lists and
    tuples with array, scalar, str and bytes leaves."""
    return packb(_state_dict(tree))


def from_state_dict(target: Any, state: Any, path: str = "") -> Any:
    """flax's `from_state_dict`: `target`'s structure (dicts, lists,
    tuples) filled from the restored `state`; a leaf is the restored value,
    as a tensor on the target's device where the target holds a tensor."""
    if isinstance(target, dict):
        missing = set(map(str, target)) - set(state)
        if missing:
            raise ValueError(f"The target dict keys and state dict keys do not match, target "
                             f"dict contains keys {missing} which are not present in state "
                             f"dict at path {path or '.'}")
        return {k: from_state_dict(v, state[str(k)], f"{path}/{k}") for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        if len(state) != len(target):
            raise ValueError(f"The size of the list and the state dict do not match, got "
                             f"{len(target)} and {len(state)} at path {path or '.'}")
        out = [from_state_dict(v, state[str(i)], f"{path}/{i}") for i, v in enumerate(target)]
        return out if isinstance(target, list) else tuple(out)
    if isinstance(target, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(state)).to(target.device)
    return state


def read_ckpt(path: Union[str, Path]) -> Any:
    """The tree of an mmtpu `.ckpt` file (`save_pytree`)."""
    return msgpack_restore(Path(path).read_bytes())
