"""TensorBoard events with the reference's tag schema (counterpart of the
JAX package's ``evaluation/tb.py``), written without ``tensorboard``.

The card's machine has no ``tensorboard`` package, so the writer encodes
the event file itself: TFRecord framing (u64 length, masked CRC32C of the
length, payload, masked CRC32C of the payload) around hand-encoded
``Event`` protobufs (``wall_time`` 1, ``step`` 2, ``file_version`` 3 =
``"brain.Event:2"``, ``summary`` 5 -> ``value {tag 1, simple_value 2 |
image 4}``).  A figure (``evaluation/plots.py``) is an image value as
``torch.utils.tensorboard.SummaryWriter.add_figure`` writes one:
``Summary.Image {height 1, width 2, colorspace 3 (RGB), encoded_image_string
4 (PNG)}``.  The file lands at
``<log_dir>/events.out.tfevents.<time>.<host>.<pid>.<n>``, as
``SummaryWriter`` names it, and TensorBoard reads it; :func:`read_scalars`
and :func:`read_images` read it back.

Events are buffered and reach the file only on :meth:`TBWriter.commit`
(the protocols commit at every unit boundary and on close);
:meth:`TBWriter.discard` drops the buffer, so a crashed unit leaves no
partial events and a resumed run's stream equals an uninterrupted one's.

On a data-parallel mesh every rank logs the same scalars; a writer whose
``rank`` is set above 0 (``engine/protocols.py`` sets the rank's) keeps
none and writes no file, so a run has one event stream, as the JAX
package's one process writes it.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    c = 0xFFFFFFFF
    for b in data:
        c = _TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1  # int64 two's complement, as protobuf encodes it
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(number: int, payload: bytes) -> bytes:
    return _varint(number << 3 | 2) + _varint(len(payload)) + payload


def _int_field(number: int, value: int) -> bytes:
    return _varint(number << 3) + _varint(value)


def encode_event(wall_time: float, step: int = 0, file_version: Optional[str] = None,
                 scalar: Optional[Tuple[str, float]] = None,
                 image: Optional[Tuple[str, int, int, int, bytes]] = None) -> bytes:
    """One ``tensorflow.Event`` protobuf message; ``image`` is (tag,
    height, width, colorspace, encoded PNG)."""
    msg = b"\x09" + struct.pack("<d", wall_time)
    if step:
        msg += b"\x10" + _varint(step)
    if file_version is not None:
        msg += _field(3, file_version.encode())
    if scalar is not None:
        tag, value = scalar
        v = _field(1, tag.encode()) + b"\x15" + struct.pack("<f", value)
        msg += _field(5, _field(1, v))
    if image is not None:
        tag, height, width, colorspace, png = image
        img = (_int_field(1, height) + _int_field(2, width) + _int_field(3, colorspace)
               + _field(4, png))
        msg += _field(5, _field(1, _field(1, tag.encode()) + _field(4, img)))
    return msg


def record(payload: bytes) -> bytes:
    """TFRecord framing of one payload."""
    length = struct.pack("<Q", len(payload))
    return (length + struct.pack("<I", _masked_crc(length)) + payload
            + struct.pack("<I", _masked_crc(payload)))


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    n = shift = 0
    while True:
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return n, i


def _fields(buf: bytes) -> Iterator[Tuple[int, object]]:
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        number, wire = key >> 3, key & 7
        if wire == 0:
            value, i = _read_varint(buf, i)
        elif wire == 1:
            value, i = buf[i:i + 8], i + 8
        elif wire == 5:
            value, i = buf[i:i + 4], i + 4
        elif wire == 2:
            n, i = _read_varint(buf, i)
            value, i = buf[i:i + n], i + n
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield number, value


def _summary_values(path) -> Iterator[Tuple[int, dict]]:
    """(step, {field number: value}) of every summary value in one event
    file, in file order; the records' checksums are verified."""
    data = Path(path).read_bytes()
    i = 0
    while i < len(data):
        header = data[i:i + 8]
        (n,) = struct.unpack("<Q", header)
        if struct.unpack("<I", data[i + 8:i + 12])[0] != _masked_crc(header):
            raise ValueError(f"{path}: corrupt record length at byte {i}")
        payload = data[i + 12:i + 12 + n]
        if struct.unpack("<I", data[i + 12 + n:i + 16 + n])[0] != _masked_crc(payload):
            raise ValueError(f"{path}: corrupt record at byte {i}")
        i += 16 + n
        step = 0
        for number, value in _fields(payload):
            if number == 2:
                step = value - (1 << 64) if value >= 1 << 63 else value
            elif number == 5:
                for _, v in _fields(value):
                    yield step, dict(_fields(v))


def read_scalars(path) -> List[Tuple[str, int, float]]:
    """(tag, step, value) of every scalar event in one event file, in file
    order; the records' checksums are verified."""
    return [(f[1].decode(), step, struct.unpack("<f", f[2])[0])
            for step, f in _summary_values(path) if 2 in f]


def read_images(path) -> List[Tuple[str, int, dict]]:
    """(tag, step, {height, width, colorspace, png}) of every image event in
    one event file, in file order."""
    out = []
    for step, f in _summary_values(path):
        if 4 in f:
            img = dict(_fields(f[4]))
            out.append((f[1].decode(), step, dict(height=img.get(1, 0), width=img.get(2, 0),
                                                  colorspace=img.get(3, 0), png=img.get(4, b""))))
    return out


class TBWriter:
    _files = 0  # the SummaryWriter file-name counter

    def __init__(self, log_dir: Optional[str]):
        self.log_dir = log_dir
        self.rank = 0
        self._file = None
        self._pending: List[Tuple[str, str, object, int]] = []

    @property
    def enabled(self) -> bool:
        return self.log_dir is not None

    @property
    def writes(self) -> bool:
        """Whether events given to this writer reach a file (enabled, rank 0)."""
        return self.enabled and self.rank == 0

    def add_scalar(self, tag: str, value, step: int) -> None:
        if self.writes:
            self._pending.append(("scalar", tag, float(value), int(step)))

    def add_figure(self, tag: str, figure, step: int = 0) -> None:
        """Buffer an ``evaluation/plots.py`` figure as an RGB PNG image event."""
        if self.writes:
            self._pending.append(("figure", tag, figure, int(step)))

    def _open(self):
        Path(self.log_dir).mkdir(parents=True, exist_ok=True)
        TBWriter._files += 1
        name = (f"events.out.tfevents.{int(time.time()):010d}.{socket.gethostname()}"
                f".{os.getpid()}.{TBWriter._files - 1}")
        f = open(Path(self.log_dir) / name, "ab")
        f.write(record(encode_event(time.time(), file_version="brain.Event:2")))
        f.flush()
        return f

    def commit(self) -> None:
        """Write every buffered event to the event file and flush."""
        if not self.writes:
            return
        if self._file is None:
            self._file = self._open()
        # pop as written: a retried commit must not write an event twice
        while self._pending:
            kind, tag, payload, step = self._pending[0]
            if kind == "scalar":
                event = encode_event(time.time(), step, scalar=(tag, payload))
            else:
                width, height = payload.size
                event = encode_event(time.time(), step, image=(tag, height, width, 3, payload.png()))
            self._file.write(record(event))
            self._pending.pop(0)
        self._file.flush()

    def discard(self) -> None:
        """Drop buffered events (the unit they belong to is re-run on resume)."""
        self._pending = []

    def flush(self) -> None:
        self.commit()

    def close(self) -> None:
        self.commit()
        if self._file is not None:
            self._file.close()
            self._file = None
