"""A reader for mmtpu's `.ckpt` files: flax's msgpack serialisation
(`flax.serialization.msgpack_restore`), in plain Python, since the card's
machine has no `msgpack` package. The port reads these files and never
writes them.

It decodes the msgpack types flax writes — nil, booleans, integers,
floats, str, bin, arrays (as lists) and maps (as dicts) — and flax's
extension types: 1, an ndarray packed as msgpack (shape, dtype name,
C-order buffer); 2, a complex number; 3, a numpy scalar packed as an
ndarray. Arrays above flax's 1 GiB chunk size, which flax stores as
`{"__msgpack_chunked_array__": True, "shape": …, "chunks": …}`, are joined
back. `str` and `bytes` leaves (mmtpu's `resume_meta`) stay as they are.
A bfloat16 array becomes float32 (numpy has no bfloat16; the widening is
exact). Every array is a writable copy.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any, Tuple, Union

import numpy as np

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


def read_ckpt(path: Union[str, Path]) -> Any:
    """The tree of an mmtpu `.ckpt` file (`save_pytree`)."""
    return msgpack_restore(Path(path).read_bytes())
