"""HDF5 reading and writing without h5py, for the pseudo-label corpora.

The corpus of ``apis/pseudo_labels.py`` (and of the JAX package's
``tools/gen_pseudo_labels.py``, which writes it through h5py) is one HDF5
file an image whose root group holds flat arrays. This module reads and
writes the subset of the format that h5py 3.x writes for such a file by
default (``libver='earliest'``):

* superblock version 0 (or 1), 8-byte offsets and lengths;
* version-1 object headers, following continuation messages (0x10);
* a root group kept as a symbol table (message 0x11): a version-1 group
  B-tree of any depth over symbol-table nodes (``SNOD``) whose names sit
  in a local heap;
* datasets with a dataspace (0x01, simple or scalar), a datatype (0x03:
  IEEE float16, float32, float64, or an integer of 1, 2, 4 or 8 bytes,
  either byte order), a fill value (0x05) and a version-3 contiguous
  layout (0x08). Data never written (the undefined address) reads as the
  fill value, zero unless one is stored.

Anything else raises ``UnsupportedH5`` naming what it met: chunked or
compact layouts, filters, external storage, superblock versions 2 and 3,
version-2 object headers, new-style groups (link messages), nested
groups, shared or committed datatypes, and other datatype classes.

``write_h5`` writes a whole file from a dict of arrays, in the layout
h5py gives the same datasets: h5py opens it and reads back every array
bit for bit under the same keys, and ``read_h5`` reads whatever it
writes. It has no append mode: a file is rewritten whole.
"""
from __future__ import annotations

import os
import struct
from typing import Dict, Iterable, Optional

import numpy as np

SIGNATURE = b'\x89HDF\r\n\x1a\n'
UNDEF = 0xffffffffffffffff
# the local heap's on-disk end of its free list (H5HL_FREE_NULL)
HEAP_FREE_NULL = 1
# group B-tree and symbol-table node ranks of the default file creation
# properties: a leaf holds up to 2 * LEAF_K symbols, a B-tree node up to
# 2 * INTERNAL_K children
LEAF_K, INTERNAL_K = 4, 16
SNOD_SIZE = 8 + 2 * LEAF_K * 40
BTREE_SIZE = 24 + (2 * INTERNAL_K + 1) * 8 + 2 * INTERNAL_K * 8
# (size, exponent location, exponent size, mantissa size, bias) of the
# IEEE types, by byte size
_FLOATS = {2: (10, 5, 10, 15), 4: (23, 8, 23, 127), 8: (52, 11, 52, 1023)}
_MSG_NAMES = {0x02: 'link info', 0x06: 'link', 0x07: 'external data files',
              0x0A: 'group info', 0x0B: 'filter pipeline'}


class UnsupportedH5(ValueError):
    """A file, or a part of one, outside the subset this module handles."""


def _u(buf, off, n):
    return int.from_bytes(buf[off:off + n], 'little')


class _Reader:

    def __init__(self, f):
        self.f = f
        self.base = 0

    def read(self, addr, n):
        self.f.seek(self.base + addr)
        data = self.f.read(n)
        if len(data) != n:
            raise UnsupportedH5(f'truncated file: {n} bytes at {addr} '
                                f'ask past its end')
        return data

    def superblock(self):
        self.f.seek(0, os.SEEK_END)
        size = self.f.tell()
        where = 0
        while where + 8 <= size:
            self.f.seek(where)
            if self.f.read(8) == SIGNATURE:
                break
            where = 512 if where == 0 else where * 2
        else:
            raise UnsupportedH5('no HDF5 signature')
        sb = self.read(where, 24)
        version = sb[8]
        if version not in (0, 1):
            raise UnsupportedH5(f'superblock version {version} (only 0 and '
                                f'1 are read)')
        if sb[13] != 8 or sb[14] != 8:
            raise UnsupportedH5(f'{sb[13]}-byte offsets and {sb[14]}-byte '
                                f'lengths (only 8 are read)')
        rest = where + 24 + (4 if version == 1 else 0)
        addrs = self.read(rest, 32 + 40)
        self.base = _u(addrs, 0, 8)
        return _u(addrs, 32 + 8, 8)          # the root entry's header

    def messages(self, addr):
        """[(type, flags, data)] of the version-1 object header at
        ``addr``, continuation blocks followed."""
        head = self.read(addr, 16)
        if head[:4] == b'OHDR':
            raise UnsupportedH5('version-2 object header')
        if head[0] != 1:
            raise UnsupportedH5(f'object header version {head[0]}')
        left = _u(head, 2, 2)
        blocks = [(addr + 16, _u(head, 8, 4))]
        out = []
        while blocks and left:
            start, length = blocks.pop(0)
            block = self.read(start, length)
            off = 0
            while off + 8 <= length and left:
                mtype, size, flags = _u(block, off, 2), _u(block, off + 2, 2), \
                    block[off + 4]
                data = block[off + 8:off + 8 + size]
                off += 8 + size
                left -= 1
                if mtype == 0x10:
                    blocks.append((_u(data, 0, 8), _u(data, 8, 8)))
                elif mtype:
                    out.append((mtype, flags, data))
        return out

    def symbols(self, btree, heap):
        """[(name, header address, cache type)] of a symbol-table group, in
        name order."""
        hh = self.read(heap, 32)
        if hh[:4] != b'HEAP':
            raise UnsupportedH5(f'no local heap at {heap}')
        names = self.read(_u(hh, 24, 8), _u(hh, 8, 8))
        out = []
        self._walk(btree, names, out)
        return out

    def _walk(self, addr, names, out):
        head = self.read(addr, 24)
        if head[:4] != b'TREE' or head[4] != 0:
            raise UnsupportedH5(f'no group B-tree node at {addr}')
        level, used = head[5], _u(head, 6, 2)
        body = self.read(addr + 24, used * 16 + 8)
        for i in range(used):
            child = _u(body, i * 16 + 8, 8)
            if level:
                self._walk(child, names, out)
                continue
            node = self.read(child, 8)
            if node[:4] != b'SNOD':
                raise UnsupportedH5(f'no symbol-table node at {child}')
            n = _u(node, 6, 2)
            entries = self.read(child + 8, 40 * n)
            for j in range(n):
                e = entries[40 * j:40 * (j + 1)]
                start = _u(e, 0, 8)
                name = names[start:names.index(b'\0', start)].decode()
                out.append((name, _u(e, 8, 8), _u(e, 16, 4)))


def _dataspace(data):
    version, rank = data[0], data[1]
    if version == 1:
        dims = data[8:8 + 8 * rank]
    elif version == 2:
        if data[3] == 2:
            raise UnsupportedH5('null dataspace')
        dims = data[4:4 + 8 * rank]
    else:
        raise UnsupportedH5(f'dataspace version {version}')
    return tuple(_u(dims, 8 * i, 8) for i in range(rank))


def _datatype(data):
    cls, version = data[0] & 0x0F, data[0] >> 4
    bits, size = data[1], _u(data, 4, 4)
    order = '>' if bits & 1 else '<'
    if cls == 0 and size in (1, 2, 4, 8):
        return np.dtype(f'{order}{"i" if bits & 8 else "u"}{size}')
    if cls == 1 and size in _FLOATS and not bits & 0x40:
        exp_loc, exp_size, mant_size, bias = _FLOATS[size]
        props = (data[12], data[13], data[15], _u(data, 16, 4))
        if props == (exp_loc, exp_size, mant_size, bias) and \
                data[2] == 8 * size - 1:
            return np.dtype(f'{order}f{size}')
    raise UnsupportedH5(f'datatype class {cls} version {version} of {size} '
                        f'bytes (bit field {data[1:4].hex()}): only IEEE '
                        f'floats and integers are read')


def _fill(data, dtype):
    """The stored fill value's bytes, or None for the default (zeros)."""
    version = data[0]
    if version in (1, 2):
        if version == 2 and not data[3]:
            return None
        size = _u(data, 4, 4)
        return data[8:8 + size] if size == dtype.itemsize else None
    if version == 3 and data[1] & 0x20:
        size = _u(data, 2, 4)
        return data[6:6 + size] if size == dtype.itemsize else None
    return None


def _dataset(reader, name, messages):
    shape = dtype = layout = None
    fill = b''
    for mtype, flags, data in messages:
        if mtype in _MSG_NAMES:
            what = _MSG_NAMES[mtype]
            if mtype in (0x02, 0x06, 0x0A):
                what += ' message: a new-style group'
            raise UnsupportedH5(f'{name!r}: {what}')
        if mtype == 0x11:
            raise UnsupportedH5(f'{name!r}: a nested group')
        if mtype in (0x01, 0x03, 0x05) and flags & 0x02:
            raise UnsupportedH5(f'{name!r}: a shared message (type '
                                f'{mtype:#x})')
        if mtype == 0x01:
            shape = _dataspace(data)
        elif mtype == 0x03:
            dtype = _datatype(data)
        elif mtype == 0x05:
            fill = data
        elif mtype == 0x08:
            layout = data
    if shape is None or dtype is None or layout is None:
        raise UnsupportedH5(f'{name!r}: not a dataset (no dataspace, '
                            f'datatype or layout message)')
    if layout[0] != 3:
        raise UnsupportedH5(f'{name!r}: layout message version {layout[0]} '
                            f'(only 3 is read)')
    if layout[1] != 1:
        kind = {0: 'compact', 2: 'chunked'}.get(layout[1],
                                                f'class {layout[1]}')
        raise UnsupportedH5(f'{name!r}: {kind} layout (only contiguous is '
                            f'read)')
    addr, size = _u(layout, 2, 8), _u(layout, 10, 8)
    count = int(np.prod(shape, dtype=np.int64))
    if addr == UNDEF:
        value = _fill(fill, dtype) if fill else None
        if value is None:
            return np.zeros(shape, dtype)
        return np.full(shape, np.frombuffer(value, dtype)[0], dtype)
    if size != count * dtype.itemsize:
        raise UnsupportedH5(f'{name!r}: {size} stored bytes for {shape} '
                            f'{dtype}')
    reader.f.seek(reader.base + addr)
    out = np.fromfile(reader.f, dtype, count)
    if out.size != count:
        raise UnsupportedH5(f'{name!r}: truncated data')
    return out.reshape(shape)


def _root_group(reader):
    """The B-tree and local heap addresses of the root symbol table."""
    msgs = reader.messages(reader.superblock())
    stab = [d for t, _, d in msgs if t == 0x11]
    if not stab:
        kinds = sorted({_MSG_NAMES.get(t, f'{t:#x}') for t, _, _ in msgs})
        raise UnsupportedH5(f'the root group has no symbol table (a '
                            f'new-style group: {kinds})')
    return _u(stab[0], 0, 8), _u(stab[0], 8, 8)


def read_h5(path: str,
            keys: Optional[Iterable[str]] = None) -> Dict[str, np.ndarray]:
    """Every dataset of the root group of ``path`` as a numpy array in
    its stored dtype and byte order (or, with ``keys``, those of them the
    file holds), in the file's name order."""
    want = None if keys is None else set(keys)
    out = {}
    with open(path, 'rb') as f:
        reader = _Reader(f)
        for name, addr, cache in reader.symbols(*_root_group(reader)):
            if cache == 1:
                raise UnsupportedH5(f'{name!r}: a nested group')
            if cache not in (0, 1):
                raise UnsupportedH5(f'{name!r}: a symbolic link')
            if want is None or name in want:
                out[name] = _dataset(reader, name, reader.messages(addr))
    return out


def _message(mtype, data, flags=0):
    data = data + b'\0' * (-len(data) % 8)
    return struct.pack('<HHB3x', mtype, len(data), flags) + data


def _object_header(messages):
    body = b''.join(messages)
    return struct.pack('<BBHII4x', 1, 0, len(messages), 1, len(body)) + body


def _datatype_message(dtype):
    order = 1 if dtype.byteorder == '>' or (
        dtype.byteorder == '=' and not np.little_endian) else 0
    size = dtype.itemsize
    if dtype.kind == 'f' and size in _FLOATS:
        exp_loc, exp_size, mant_size, bias = _FLOATS[size]
        head = struct.pack('<BBBBI', 0x11, 0x20 | order, 8 * size - 1, 0,
                           size)
        return head + struct.pack('<HHBBBBI', 0, 8 * size, exp_loc,
                                  exp_size, 0, mant_size, bias)
    if dtype.kind in 'iu' and size in (1, 2, 4, 8):
        bits = order | (8 if dtype.kind == 'i' else 0)
        return struct.pack('<BBBBIHH', 0x10, bits, 0, 0, size, 0, 8 * size)
    raise UnsupportedH5(f'cannot write dtype {dtype}: only IEEE floats and '
                        f'integers')


def _dataset_header(arr, addr):
    shape = arr.shape
    space = struct.pack('<BBBB4x', 1, len(shape), 1 if shape else 0, 0) + \
        b''.join(struct.pack('<Q', d) for d in shape) * (2 if shape else 0)
    layout = struct.pack('<BBQQ', 3, 1, addr if arr.nbytes else UNDEF,
                         arr.nbytes)
    return _object_header([
        _message(0x01, space),
        _message(0x03, _datatype_message(arr.dtype), flags=1),
        # fill value version 2: late allocation, written if set, the
        # library's default value (size 0), as h5py leaves it
        _message(0x05, struct.pack('<BBBBI', 2, 2, 2, 1, 0), flags=1),
        _message(0x08, layout)])


def write_h5(path: str, arrays: Dict[str, np.ndarray]):
    """Write ``arrays`` (name -> array of an IEEE float or integer dtype) as
    the datasets of a new HDF5 file at ``path``, replacing it whole (a
    temporary file renamed into place)."""
    arrays = {str(k): np.asarray(v) for k, v in arrays.items()}
    names = sorted(arrays, key=lambda s: s.encode())
    for name in names:
        if not name or '/' in name or '\0' in name or name == '.':
            raise UnsupportedH5(f'cannot write a dataset named {name!r}')
    nodes = [names[i:i + 2 * LEAF_K]
             for i in range(0, len(names), 2 * LEAF_K)]
    if len(nodes) > 2 * INTERNAL_K:
        raise UnsupportedH5(f'{len(names)} datasets need a B-tree of more '
                            f'than one level; at most '
                            f'{4 * LEAF_K * INTERNAL_K} are written')
    heap_data = bytearray(8)                 # offset 0: the empty name
    offsets = {}
    for name in names:
        offsets[name] = len(heap_data)
        raw = name.encode() + b'\0'
        heap_data += raw + b'\0' * (-len(raw) % 8)

    root_oh, btree, heap = 96, 136, 136 + BTREE_SIZE
    heap_at = heap + 32
    snod_at = heap_at + len(heap_data)
    pos = snod_at + SNOD_SIZE * len(nodes)
    headers, header_at = {}, {}
    data_at = pos + sum(len(_dataset_header(arrays[n], 0)) for n in names)
    for name in names:
        headers[name] = _dataset_header(arrays[name], data_at)
        header_at[name] = pos
        pos += len(headers[name])
        data_at += arrays[name].nbytes
    eof = data_at

    def entry(name_off, header, cache=0, scratch=b'\0' * 16):
        return struct.pack('<QQI4x', name_off, header, cache) + scratch

    superblock = SIGNATURE + struct.pack(
        '<BBBBBBBBHHIQQQQ', 0, 0, 0, 0, 0, 8, 8, 0, LEAF_K, INTERNAL_K, 0,
        0, UNDEF, eof, UNDEF) + entry(0, root_oh, 1, struct.pack(
            '<QQ', btree, heap))
    root = _object_header([_message(0x11, struct.pack('<QQ', btree, heap))])
    tree = bytearray(struct.pack('<4sBBHQQ', b'TREE', 0, 0, len(nodes),
                                 UNDEF, UNDEF))
    tree += struct.pack('<Q', 0)
    for i, node in enumerate(nodes):
        tree += struct.pack('<QQ', snod_at + SNOD_SIZE * i,
                            offsets[node[-1]])
    tree += b'\0' * (BTREE_SIZE - len(tree))
    heap_head = struct.pack('<4sB3xQQQ', b'HEAP', 0, len(heap_data),
                            HEAP_FREE_NULL, heap_at)
    snods = bytearray()
    for node in nodes:
        block = bytearray(struct.pack('<4sBBH', b'SNOD', 1, 0, len(node)))
        for name in node:
            block += entry(offsets[name], header_at[name])
        snods += block + b'\0' * (SNOD_SIZE - len(block))
    meta = superblock + root + bytes(tree) + heap_head + bytes(heap_data) + \
        bytes(snods) + b''.join(headers[n] for n in names)
    assert len(superblock) == root_oh and len(meta) == pos
    tmp = f'{path}.tmp{os.getpid()}'
    try:
        with open(tmp, 'wb') as f:
            f.write(meta)
            for name in names:
                arr = np.ascontiguousarray(arrays[name])
                if arr.nbytes:
                    f.write(memoryview(arr.reshape(-1)).cast('B'))
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
