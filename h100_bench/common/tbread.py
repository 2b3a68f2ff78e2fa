"""Scalars from TensorBoard event files (TFRecord framing, ``Event``
protobuf), read without TensorBoard: the training cells read the losses a
run logged."""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Dict, Iterator, List, Tuple


def _varint(buf: bytes, i: int) -> Tuple[int, int]:
    out = shift = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return out, i


def _fields(buf: bytes) -> Iterator[Tuple[int, object]]:
    i = 0
    while i < len(buf):
        key, i = _varint(buf, i)
        num, wire = key >> 3, key & 7
        if wire == 0:
            val, i = _varint(buf, i)
        elif wire == 1:
            val, i = buf[i:i + 8], i + 8
        elif wire == 2:
            n, i = _varint(buf, i)
            val, i = buf[i:i + n], i + n
        elif wire == 5:
            val, i = buf[i:i + 4], i + 4
        else:
            raise ValueError(f"wire type {wire}")
        yield num, val


def scalars(directory) -> Dict[str, List[Tuple[int, float]]]:
    """{tag: [(step, value), ...]} over every event file under ``directory``."""
    out: Dict[str, List[Tuple[int, float]]] = {}
    for path in sorted(Path(directory).rglob("events.out.tfevents.*")):
        data = path.read_bytes()
        i = 0
        while i + 12 <= len(data):
            (n,) = struct.unpack_from("<Q", data, i)
            payload = data[i + 12:i + 12 + n]
            i += 12 + n + 4
            step = 0
            for num, val in _fields(payload):
                if num == 2:
                    step = val
                elif num == 5:
                    for vnum, value in _fields(val):
                        if vnum != 1:
                            continue
                        tag, simple = None, None
                        for fnum, f in _fields(value):
                            if fnum == 1:
                                tag = f.decode()
                            elif fnum == 2:
                                (simple,) = struct.unpack("<f", f)
                        if tag is not None and simple is not None:
                            out.setdefault(tag, []).append((step, simple))
    return out
