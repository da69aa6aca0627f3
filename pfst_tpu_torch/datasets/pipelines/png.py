"""PNG reading and writing without an image library.

The port reads its datasets with its own decoder instead of
``cv2.imread``, in cv2's conventions (colour images in BGR order): the
chunks are parsed here, ``zlib`` inflates the image data and the row
filters are undone by ``native/hostaug.cc``. Supported: 8-bit grayscale,
RGB and RGBA images, and 16-bit grayscale ones read unchanged (a height
map as ``cv2.imwrite`` stores a uint16 array), not interlaced, with any
of the five row filters -- what ``cv2.imwrite`` and the repository's
dataset converters write. Any other PNG, and any other format, raises
``UnsupportedImage``: such a
directory is read through a pack (``pipelines/packing.py``) written by
``tools/pack_dataset.py`` where cv2 is installed.

The writer stores 8-bit grayscale, BGR (as RGB) or BGRA (as RGBA) images
with no row filter.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

from ...native import hostaug

SIGNATURE = b'\x89PNG\r\n\x1a\n'
# colour type -> channels, of the 8-bit images supported
_CHANNELS = {0: 1, 2: 3, 6: 4}


class UnsupportedImage(ValueError):
    """An image this decoder does not read."""


def _unsupported(path, why):
    return UnsupportedImage(
        f'{path}: {why}. The port decodes 8-bit grayscale, RGB and RGBA '
        f'PNGs, and 16-bit grayscale ones read unchanged, that are not '
        f'interlaced; pack other images with '
        f'tools/pack_dataset.py where cv2 is installed (the packs of '
        f'tools/pack_dataset.py and tools/pack_dataset_torch.py are read by '
        f'both packages)')


def read_png(path: str, mode: str = 'color') -> np.ndarray:
    """Decode ``path`` as ``cv2.imread`` would with ``mode`` 'color'
    (IMREAD_COLOR: (H, W, 3) BGR), 'grayscale' (a grayscale PNG as
    (H, W); the grayscale of a colour PNG is not supported) or
    'unchanged' (IMREAD_UNCHANGED: (H, W), BGR or BGRA)."""
    with open(path, 'rb') as f:
        raw = f.read()
    if raw[:8] != SIGNATURE:
        raise _unsupported(path, 'not a PNG file')
    pos, header, idat = 8, None, []
    while pos + 8 <= len(raw):
        length, kind = struct.unpack('>I4s', raw[pos:pos + 8])
        body = raw[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError(f'{path}: truncated PNG chunk {kind!r}')
        pos += 12 + length
        if kind == b'IHDR':
            header = struct.unpack('>IIBBBBB', body)
        elif kind == b'IDAT':
            idat.append(body)
        elif kind == b'IEND':
            break
    if header is None or not idat:
        raise ValueError(f'{path}: PNG without IHDR or IDAT')
    width, height, depth, ctype, _, _, interlace = header
    gray16 = depth == 16 and ctype == 0 and mode == 'unchanged'
    if not gray16 and (depth != 8 or ctype not in _CHANNELS):
        raise _unsupported(path, f'bit depth {depth}, colour type {ctype}, '
                                 f'{mode} read')
    if interlace:
        raise _unsupported(path, 'interlaced')
    if gray16:
        # big-endian samples; the filters work on bytes, two a pixel
        rows = hostaug.png_unfilter(zlib.decompress(b''.join(idat)),
                                    height, width * 2, 2)
        return rows.view('>u2').astype(np.uint16).reshape(height, width)
    channels = _CHANNELS[ctype]
    rows = hostaug.png_unfilter(zlib.decompress(b''.join(idat)), height,
                                width * channels, channels)
    img = rows.reshape(height, width, channels)
    if mode == 'grayscale':
        if channels != 1:
            raise _unsupported(path, 'grayscale read of a colour PNG')
        return img[..., 0].copy()
    if channels == 1:
        return img[..., 0].copy() if mode == 'unchanged' else \
            np.repeat(img, 3, axis=2)
    if mode == 'unchanged' and channels == 4:
        return np.ascontiguousarray(img[..., [2, 1, 0, 3]])
    return np.ascontiguousarray(img[..., 2::-1])


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack('>I', len(body)) + kind + body + struct.pack(
        '>I', zlib.crc32(kind + body) & 0xffffffff)


def write_png(path: str, img: np.ndarray, level: int = 1) -> None:
    """Write an (H, W) grayscale, (H, W, 3) BGR or (H, W, 4) BGRA uint8
    image as ``cv2.imwrite`` would store it (RGB(A) order in the file)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f'write_png takes uint8 images, got {img.dtype}')
    if img.ndim == 2:
        ctype, data = 0, img[..., None]
    elif img.ndim == 3 and img.shape[2] in (3, 4):
        ctype = 2 if img.shape[2] == 3 else 6
        order = [2, 1, 0] if img.shape[2] == 3 else [2, 1, 0, 3]
        data = img[..., order]
    else:
        raise ValueError(f'write_png takes (H, W), (H, W, 3) or (H, W, 4) '
                         f'images, got {img.shape}')
    height, width = img.shape[:2]
    rows = np.zeros((height, 1 + width * data.shape[2]), np.uint8)
    rows[:, 1:] = data.reshape(height, -1)
    with open(path, 'wb') as f:
        f.write(SIGNATURE)
        f.write(_chunk(b'IHDR', struct.pack('>IIBBBBB', width, height, 8,
                                            ctype, 0, 0, 0)))
        f.write(_chunk(b'IDAT', zlib.compress(rows.tobytes(), level)))
        f.write(_chunk(b'IEND', b''))
