"""TensorBoard event files without tensorflow or tensorboard.

An event file is a sequence of TFRecords: the length of the record as a
little-endian uint64, the masked CRC-32C of those 8 bytes (uint32), the
record, and the masked CRC-32C of the record. Each record is an ``Event``
protobuf (``tensorboard/compat/proto/event.proto``): ``wall_time``
(field 1, double), ``step`` (2, int64), ``file_version`` (3, string) or
``summary`` (5), whose repeated ``value`` (1) holds a ``tag`` (1, string)
and a ``simple_value`` (2, float). The first event of a file carries
``file_version`` 'brain.Event:2'. The encoding needs varints, fixed
32- and 64-bit fields and length-delimited fields only, so it is written
here by hand.

``EventFileWriter`` writes scalar events; ``read_events`` reads a file
back, checking every CRC, and decodes the fields above (other fields are
skipped by their wire type).
"""
from __future__ import annotations

import os
import os.path as osp
import socket
import struct
import time
from typing import Dict, Iterable, List, Tuple

FILE_VERSION = 'brain.Event:2'


def _crc32c_table():
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ 0x82F63B78 if crc & 1 else crc >> 1
        table.append(crc)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) of ``data``."""
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """The TFRecord mask of the CRC-32C: rotated right by 15 bits, plus a
    constant."""
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(value: int) -> bytes:
    value &= (1 << 64) - 1          # int64 fields encode negatives in 10
    out = bytearray()
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _field(number: int, wire: int, body: bytes) -> bytes:
    if wire == 2:
        body = _varint(len(body)) + body
    return _varint(number << 3 | wire) + body


def encode_event(wall_time: float, step: int = 0, file_version=None,
                 scalars: Iterable[Tuple[str, float]] = ()) -> bytes:
    """The ``Event`` protobuf of a file-version event or of scalars."""
    out = _field(1, 1, struct.pack('<d', wall_time))
    if step:
        out += _field(2, 0, _varint(step))
    if file_version is not None:
        out += _field(3, 2, file_version.encode())
    values = b''.join(
        _field(1, 2, _field(1, 2, tag.encode()) +
               _field(2, 5, struct.pack('<f', value)))
        for tag, value in scalars)
    if values:
        out += _field(5, 2, values)
    return out


def frame(record: bytes) -> bytes:
    """``record`` as a TFRecord."""
    length = struct.pack('<Q', len(record))
    return (length + struct.pack('<I', masked_crc32c(length)) + record +
            struct.pack('<I', masked_crc32c(record)))


class EventFileWriter:
    """One ``events.out.tfevents.*`` file under ``log_dir``, its first
    event the file version. ``add_scalars`` writes one event of scalars
    and flushes it, so a TensorBoard reading the directory sees each
    interval as it is written."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        now = time.time()
        self.path = osp.join(
            log_dir, f'events.out.tfevents.{int(now):010d}.'
            f'{socket.gethostname()}.{os.getpid()}')
        self._f = open(self.path, 'wb')
        self._f.write(frame(encode_event(now, file_version=FILE_VERSION)))

    def add_scalars(self, step: int, scalars: Dict[str, float]):
        self._f.write(frame(encode_event(time.time(), step,
                                         scalars=scalars.items())))
        self._f.flush()

    def close(self):
        if not self._f.closed:
            self._f.close()


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    value = shift = 0
    while True:
        byte = buf[pos]
        pos += 1
        value |= (byte & 0x7F) << shift
        shift += 7
        if not byte & 0x80:
            return value, pos


def _fields(buf: bytes):
    """(field number, wire type, value) of each field of a message:
    value an int (varint), bytes (fixed 64 or 32 bits, length-delimited)."""
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        number, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _read_varint(buf, pos)
        elif wire == 1:
            value, pos = buf[pos:pos + 8], pos + 8
        elif wire == 5:
            value, pos = buf[pos:pos + 4], pos + 4
        elif wire == 2:
            n, pos = _read_varint(buf, pos)
            value, pos = buf[pos:pos + n], pos + n
        else:
            raise ValueError(f'unsupported protobuf wire type {wire}')
        yield number, wire, value


def decode_event(record: bytes) -> dict:
    """``{'wall_time', 'step', 'file_version' (or None), 'scalars': [(tag,
    simple_value), ...]}`` of an ``Event`` protobuf."""
    event = {'wall_time': 0.0, 'step': 0, 'file_version': None,
             'scalars': []}
    for number, wire, value in _fields(record):
        if number == 1 and wire == 1:
            event['wall_time'] = struct.unpack('<d', value)[0]
        elif number == 2 and wire == 0:
            event['step'] = value - (1 << 64) if value >> 63 else value
        elif number == 3 and wire == 2:
            event['file_version'] = value.decode()
        elif number == 5 and wire == 2:
            for vn, vw, v in _fields(value):
                if vn != 1 or vw != 2:
                    continue
                tag, simple = None, None
                for fn, fw, f in _fields(v):
                    if fn == 1 and fw == 2:
                        tag = f.decode()
                    elif fn == 2 and fw == 5:
                        simple = struct.unpack('<f', f)[0]
                if tag is not None and simple is not None:
                    event['scalars'].append((tag, simple))
    return event


def read_events(path: str) -> List[dict]:
    """Every event of the file at ``path``, each record's two CRCs
    checked (a mismatch or a truncated record raises ``ValueError``)."""
    with open(path, 'rb') as f:
        raw = f.read()
    events, pos = [], 0
    while pos < len(raw):
        if pos + 12 > len(raw):
            raise ValueError(f'{path}: truncated record header at {pos}')
        length = raw[pos:pos + 8]
        (n,) = struct.unpack('<Q', length)
        (crc,) = struct.unpack('<I', raw[pos + 8:pos + 12])
        if crc != masked_crc32c(length):
            raise ValueError(f'{path}: length CRC mismatch at {pos}')
        record = raw[pos + 12:pos + 12 + n]
        tail = raw[pos + 12 + n:pos + 16 + n]
        if len(record) != n or len(tail) != 4:
            raise ValueError(f'{path}: truncated record at {pos}')
        if struct.unpack('<I', tail)[0] != masked_crc32c(record):
            raise ValueError(f'{path}: data CRC mismatch at {pos}')
        events.append(decode_event(record))
        pos += 16 + n
    return events
