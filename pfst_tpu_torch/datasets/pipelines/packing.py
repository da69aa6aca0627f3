"""Packed image store: one mmap-able blob and a JSON index per directory
(port of ``pfst_tpu/datasets/pipelines/packing.py``).

The format is the JAX file's, under the same names (``.pfst_pack.bin*``
and ``.pfst_pack.json``), so a pack written by either package is read by
both: ``imread`` (``pipelines/loading.py``) serves a packed file from a
memmap slice instead of decoding it. The reader is numpy alone. The
writer decodes with the port's PNG and TIFF readers
(``pipelines/imdecode.py``) where the JAX file calls
``cv2.imread(IMREAD_UNCHANGED)``; directories of other formats are packed
by the JAX package's ``tools/pack_dataset.py``. As in the JAX file, a
16-bit image is packed but a colour read of it is decoded from disk.

    python tools/pack_dataset_torch.py data/Potsdam_IRRG_1024 --recursive
"""
from __future__ import annotations

import itertools
import json
import os
import os.path as osp
from typing import Dict, Optional

import numpy as np

from .imdecode import read_image

PACK_BIN = '.pfst_pack.bin'
PACK_IDX = '.pfst_pack.json'
IMAGE_EXTS = ('.png', '.jpg', '.jpeg', '.tif', '.tiff', '.bmp')
_PACK_IDS = itertools.count(1)


def pack_directory(directory: str) -> int:
    """Decode every image in ``directory`` unchanged (the lossless
    representation) into one flat blob and its index; return the number
    of images packed (0 writes nothing). Each pack writes a fresh,
    uniquely named blob that the atomically replaced index points to, so
    a concurrent reader never pairs a new index with an old blob."""
    directory = osp.abspath(directory)
    files = sorted(f for f in os.listdir(directory)
                   if f.lower().endswith(IMAGE_EXTS))
    index: Dict[str, list] = {}
    blob_name = f'{PACK_BIN}.{os.getpid()}.{next(_PACK_IDS)}'
    blob_path = osp.join(directory, blob_name)
    try:
        with open(blob_path, 'wb') as f:
            for name in files:
                arr = read_image(osp.join(directory, name), 'unchanged')
                index[name] = [f.tell(), list(arr.shape), str(arr.dtype)]
                f.write(np.ascontiguousarray(arr).tobytes())
    except BaseException:
        os.remove(blob_path)
        raise
    if not index:
        os.remove(blob_path)
        return 0
    idx_tmp = osp.join(directory, PACK_IDX + '.tmp')
    with open(idx_tmp, 'w') as f:
        json.dump({'blob': blob_name, 'entries': index}, f)
    os.replace(idx_tmp, osp.join(directory, PACK_IDX))
    # drop the blobs of earlier packs (open memmaps survive the unlink)
    for old in os.listdir(directory):
        if old.startswith(PACK_BIN) and old != blob_name \
                and not old.endswith('.tmp'):
            try:
                os.remove(osp.join(directory, old))
            except OSError:
                pass
    invalidate(directory)
    return len(index)


class _Pack:
    def __init__(self, directory: str):
        with open(osp.join(directory, PACK_IDX)) as f:
            raw = json.load(f)
        if 'entries' in raw:
            self.index = raw['entries']
            blob = raw.get('blob', PACK_BIN)
        else:  # the JAX package's earlier flat index
            self.index = raw
            blob = PACK_BIN
        self.blob = np.memmap(osp.join(directory, blob), np.uint8, mode='r')

    def get(self, name: str, color: bool,
            unchanged: bool) -> Optional[np.ndarray]:
        """The packed image in ``imread``'s mode, or None where the mode
        needs the decoder (not packed, or a conversion cv2 makes inside
        its decoder)."""
        ent = self.index.get(name)
        if ent is None:
            return None
        offset, shape, dtype = ent
        dt = np.dtype(dtype)
        arr = np.frombuffer(self.blob, dt, count=int(np.prod(shape)),
                            offset=offset).reshape(shape)
        if unchanged:
            return arr.copy()
        if color:
            if dt != np.uint8:
                return None
            if arr.ndim == 2:   # cv2.COLOR_GRAY2BGR
                return np.repeat(arr[..., None], 3, axis=2)
            if arr.ndim == 3 and arr.shape[2] in (3, 4):
                return np.ascontiguousarray(arr[..., :3])  # BGRA2BGR
            return None
        if arr.ndim == 2 and dt == np.uint8:
            return arr.copy()
        # cv2's grayscale of a colour file is converted inside its decoder
        return None


_packs: Dict[str, Optional[_Pack]] = {}


def lookup(path: str, color: bool = True,
           unchanged: bool = False) -> Optional[np.ndarray]:
    """Packed read of ``path`` with ``imread``'s mode semantics, or None
    (no pack for the directory, file not packed, or the mode needs the
    decoder)."""
    directory, name = osp.split(osp.abspath(path))
    if directory not in _packs:
        has = osp.exists(osp.join(directory, PACK_IDX))
        try:
            _packs[directory] = _Pack(directory) if has else None
        except OSError:
            _packs[directory] = None  # a torn pack: decode from disk
    pack = _packs[directory]
    if pack is None:
        return None
    return pack.get(name, color, unchanged)


def invalidate(directory: Optional[str] = None) -> None:
    """Drop cached pack handles (after re-packing, or in tests)."""
    if directory is None:
        _packs.clear()
    else:
        _packs.pop(osp.abspath(directory), None)
