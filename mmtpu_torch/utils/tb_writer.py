"""Pure-Python TensorBoard scalar event writer (own copy of
`mmtpu/utils/tb_writer.py`; no `tensorboard` package needed).

Writes a tfevents file directly: TFRecord framing with masked CRC32C and
hand-encoded Event/Summary protobuf messages, scalars only (all that the
MetricRecorder logs). The same scalars, steps and wall times give the same
bytes as mmtpu's writer, and standard TensorBoard reads the file.

Wire format:
    record  = uint64le(len) crc32c(len) data crc32c(data)   # masked CRCs
    Event   = 1: wall_time (double), 2: step (int64),
              3: file_version (string) | 5: summary (Summary)
    Summary = repeated 1: Value{1: tag (string), 2: simple_value (float)}
"""

from __future__ import annotations

import os
import socket
import struct
import time
from pathlib import Path
from typing import Dict, Optional


def _crc_table() -> list:
    poly = 0x82F63B78  # CRC-32C (Castagnoli), reflected
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    if n < 0:  # protobuf int64: two's complement, a 10-byte varint
        n += 1 << 64
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if not n:
            out.append(b)
            return bytes(out)
        out.append(b | 0x80)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _length_delimited(field: int, payload: bytes) -> bytes:
    return _key(field, 2) + _varint(len(payload)) + payload


def encode_event(wall_time: float, step: int = 0, file_version: Optional[str] = None,
                 scalars: Optional[Dict[str, float]] = None) -> bytes:
    msg = _key(1, 1) + struct.pack("<d", wall_time)
    if step:
        msg += _key(2, 0) + _varint(step)
    if file_version is not None:
        msg += _length_delimited(3, file_version.encode())
    if scalars:
        summary = b"".join(
            _length_delimited(1, _length_delimited(1, str(tag).encode())
                              + _key(2, 5) + struct.pack("<f", float(value)))
            for tag, value in scalars.items())
        msg += _length_delimited(5, summary)
    return msg


class SummaryWriter:
    """The add_scalar / add_scalars / flush / close surface of torch's
    SummaryWriter, for scalars."""

    def __init__(self, log_dir) -> None:
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        name = (f"events.out.tfevents.{int(time.time())}."
                f"{socket.gethostname()}.{os.getpid()}.0")
        self.path = self.log_dir / name
        self._fh = open(self.path, "wb")
        self._write(encode_event(time.time(), file_version="brain.Event:2"))

    def _write(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._fh.write(header + struct.pack("<I", masked_crc(header)))
        self._fh.write(payload + struct.pack("<I", masked_crc(payload)))

    def add_scalar(self, tag: str, value, global_step: int = 0) -> None:
        self._write(encode_event(time.time(), step=int(global_step or 0),
                                 scalars={tag: value}))

    def add_scalars(self, main_tag: str, tag_scalar_dict, global_step: int = 0) -> None:
        for k, v in tag_scalar_dict.items():
            self.add_scalar(f"{main_tag}/{k}", v, global_step)

    def flush(self) -> None:
        self._fh.flush()

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.flush()
            self._fh.close()
