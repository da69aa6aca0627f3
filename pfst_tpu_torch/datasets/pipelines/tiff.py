"""TIFF reading and writing without an image library.

The port reads SeasonNet's tiles with its own decoder instead of
``cv2.imread``, in cv2's conventions (colour images in BGR order). The
directory is parsed here, ``zlib`` inflates deflate data, and the LZW and
PackBits codecs are ``native/hostaug.cc``'s. Supported: baseline TIFF in
either byte order, one image, 8- or 16-bit unsigned samples, grayscale
(1 sample), RGB (3) or RGB with an unspecified extra sample (4), chunky
samples in strips or tiles, compression none (1), LZW (5), deflate (8,
32946) or PackBits (32773), with or without the horizontal predictor
(317 = 2, undone modulo 2^bits per channel). Anything else raises
``UnsupportedImage``.

What cv2 5.0 returns, and so ``read_tiff``:

* 'unchanged': the stored dtype and channels, BGR(A) order;
* 'color': BGR uint8. A 16-bit RGB(A) file is reduced by libtiff's
  ``(x * 255 + 32767) // 65535``, which is ``round(x / 257)``; a 16-bit
  grayscale file by ``x >> 8``;
* 'grayscale': (H, W) uint8. A colour file's gray is OpenCV's fixed-point
  ``(1868 b + 9617 g + 4899 r + 8192) >> 14`` of its 8-bit BGR values.

The writer stores (H, W), BGR or BGRA uint8 or uint16 images as cv2
writes them: little-endian, RGB(A) in strips of ``8192 // row bytes`` rows,
LZW (or deflate) with the horizontal predictor, unless another
compression or layout is asked for.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

from ...native import hostaug
from .png import UnsupportedImage

MAGIC = (b'II*\x00', b'MM\x00*')
COMPRESSION = {'none': 1, 'lzw': 5, 'deflate': 8, 'packbits': 32773}
# field type -> struct code of one value (BYTE, SHORT, LONG)
_FORMATS = {1: 'B', 3: 'H', 4: 'I'}
_GRAY_WEIGHTS = (1868, 9617, 4899)  # OpenCV's B, G, R weights, shift 14


def _unsupported(path, why):
    return UnsupportedImage(
        f'{path}: {why}. The port decodes baseline 8- and 16-bit grayscale, '
        f'RGB and RGBA TIFFs, chunky, in strips or tiles, uncompressed, LZW, '
        f'deflate or PackBits')


def _directory(raw: bytes, path: str):
    """The first image directory: tag -> tuple of values (the value types
    the baseline fields use), and the byte order."""
    if raw[:4] not in MAGIC:
        raise _unsupported(path, 'not a TIFF file (or a BigTIFF)')
    e = '<' if raw[:2] == b'II' else '>'
    (offset,) = struct.unpack(e + 'I', raw[4:8])
    (count,) = struct.unpack(e + 'H', raw[offset:offset + 2])
    tags = {}
    for i in range(count):
        entry = raw[offset + 2 + 12 * i:offset + 14 + 12 * i]
        tag, typ, n = struct.unpack(e + 'HHI', entry[:8])
        if typ not in _FORMATS:
            continue
        fmt = f'{e}{n}{_FORMATS[typ]}'
        size = struct.calcsize(fmt)
        if size <= 4:
            body = entry[8:8 + size]
        else:
            (at,) = struct.unpack(e + 'I', entry[8:])
            body = raw[at:at + size]
        tags[tag] = struct.unpack(fmt, body)
    return tags, e


def _decompress(data: bytes, compression: int, size: int) -> np.ndarray:
    if compression == 1:
        return np.frombuffer(data, np.uint8)[:size]
    if compression == 5:
        return hostaug.lzw_decode(data, size)
    if compression in (8, 32946):
        return np.frombuffer(zlib.decompress(data), np.uint8)[:size]
    return hostaug.packbits_decode(data, size)


def _stored(path: str):
    """The image as stored, (H, W, samples) in native byte order."""
    with open(path, 'rb') as f:
        raw = f.read()
    tags, e = _directory(raw, path)
    width, height = tags[256][0], tags[257][0]
    spp = tags.get(277, (1,))[0]
    bits = set(tags.get(258, (1,)))
    compression = tags.get(259, (1,))[0]
    photometric = tags.get(262, (None,))[0]
    predictor = tags.get(317, (1,))[0]
    if len(bits) != 1 or not bits <= {8, 16}:
        raise _unsupported(path, f'bits per sample {tags.get(258)}')
    depth = bits.pop()
    if set(tags.get(339, (1,))) != {1}:
        raise _unsupported(path, f'sample format {tags.get(339)}')
    if (spp, photometric) not in ((1, 1), (3, 2), (4, 2)):
        raise _unsupported(path, f'{spp} samples, photometric '
                                 f'{photometric}')
    if spp == 4 and set(tags.get(338, (0,))) != {0}:
        raise _unsupported(path, 'an associated or unassociated alpha')
    if tags.get(284, (1,))[0] != 1:
        raise _unsupported(path, 'planar samples')
    if compression not in (1, 5, 8, 32946, 32773):
        raise _unsupported(path, f'compression {compression}')
    if predictor not in (1, 2):
        raise _unsupported(path, f'predictor {predictor}')
    stored = np.dtype(f'{e}u{depth // 8}')
    if 322 in tags:
        cw, ch = tags[322][0], tags[323][0]
        offsets, counts = tags[324], tags[325]
        across = -(-width // cw)
        boxes = [((i // across) * ch, (i % across) * cw, ch, cw)
                 for i in range(len(offsets))]
    else:
        rows = min(tags.get(278, (height,))[0], height)
        offsets, counts = tags[273], tags[279]
        boxes = [(i * rows, 0, min(rows, height - i * rows), width)
                 for i in range(len(offsets))]
    img = np.empty((height, width, spp), stored.newbyteorder('='))
    for (y, x, h, w), off, n in zip(boxes, offsets, counts):
        size = h * w * spp * stored.itemsize
        buf = _decompress(raw[off:off + n], compression, size)
        if buf.size != size:
            raise ValueError(f'{path}: a strip or tile holds {buf.size} '
                             f'bytes, expected {size}')
        chunk = buf.view(stored).reshape(h, w, spp).astype(img.dtype)
        if predictor == 2:
            chunk = np.cumsum(chunk, axis=1, dtype=img.dtype)
        h, w = min(h, height - y), min(w, width - x)
        img[y:y + h, x:x + w] = chunk[:h, :w]
    return img


def _to_u8(img: np.ndarray) -> np.ndarray:
    """cv2's 8-bit view of a stored image: libtiff's rounding for colour
    files, the high byte for grayscale ones."""
    if img.dtype == np.uint8:
        return img
    if img.shape[2] == 1:
        return (img >> 8).astype(np.uint8)
    return ((img.astype(np.uint32) * 255 + 32767) // 65535).astype(np.uint8)


def read_tiff(path: str, mode: str = 'color') -> np.ndarray:
    """Decode ``path`` as ``cv2.imread`` would with ``mode`` 'color'
    (IMREAD_COLOR: (H, W, 3) BGR uint8), 'grayscale' (IMREAD_GRAYSCALE:
    (H, W) uint8) or 'unchanged' (IMREAD_UNCHANGED: (H, W), BGR or BGRA
    in the stored dtype)."""
    img = _stored(path)
    spp = img.shape[2]
    if mode == 'unchanged':
        if spp == 1:
            return img[..., 0].copy()
        order = [2, 1, 0] if spp == 3 else [2, 1, 0, 3]
        return np.ascontiguousarray(img[..., order])
    img = _to_u8(img)
    if mode == 'color':
        if spp == 1:
            return np.repeat(img, 3, axis=2)
        return np.ascontiguousarray(img[..., 2::-1])
    if mode != 'grayscale':
        raise ValueError(f'unknown read mode {mode!r}')
    if spp == 1:
        return img[..., 0].copy()
    r, g, b = (img[..., i].astype(np.int32) for i in range(3))
    wb, wg, wr = _GRAY_WEIGHTS
    return ((b * wb + g * wg + r * wr + (1 << 13)) >> 14).astype(np.uint8)


def write_tiff(path: str, img: np.ndarray, compression: str = 'lzw',
               big_endian: bool = False, tile: int = 0) -> None:
    """Write an (H, W), (H, W, 3) BGR or (H, W, 4) BGRA uint8 or uint16
    image as ``cv2.imwrite`` does (RGB(A) order in the file,
    little-endian, strips of ``8192 // row bytes`` rows); ``compression``
    'lzw' (cv2's default), 'deflate', 'packbits' or 'none', with the
    horizontal predictor for 'lzw' and 'deflate', as cv2 writes them.
    ``big_endian`` and ``tile`` (square tiles of that many pixels, a
    multiple of 16) write the layouts cv2 does not write but reads."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f'write_tiff takes uint8 or uint16 images, got '
                         f'{img.dtype}')
    if img.ndim == 2:
        data = img[..., None]
    elif img.ndim == 3 and img.shape[2] in (3, 4):
        data = img[..., [2, 1, 0] if img.shape[2] == 3 else [2, 1, 0, 3]]
    else:
        raise ValueError(f'write_tiff takes (H, W), (H, W, 3) or (H, W, 4) '
                         f'images, got {img.shape}')
    if tile % 16:
        raise ValueError(f'tiles are multiples of 16 pixels, got {tile}')
    e = '>' if big_endian else '<'
    comp = COMPRESSION[compression]
    predict = comp in (5, 8)
    height, width, spp = data.shape
    itemsize = data.dtype.itemsize
    if tile:
        ph, pw = -(-height // tile) * tile, -(-width // tile) * tile
        data = np.pad(data, ((0, ph - height), (0, pw - width), (0, 0)))
        boxes = [(y, x, tile, tile) for y in range(0, ph, tile)
                 for x in range(0, pw, tile)]
    else:
        rows = max(1, 8192 // (width * spp * itemsize))
        boxes = [(y, 0, rows, width) for y in range(0, height, rows)]
    out = bytearray(b'II*\x00' if e == '<' else b'MM\x00*') + bytes(4)
    offsets, counts = [], []
    for y, x, h, w in boxes:
        chunk = data[y:y + h, x:x + w]
        if predict:
            chunk = np.diff(chunk, axis=1,
                            prepend=np.zeros_like(chunk[:, :1]))
        body = np.ascontiguousarray(chunk, chunk.dtype.newbyteorder(e))
        body = body.tobytes()
        if comp == 5:
            body = hostaug.lzw_encode(body)
        elif comp == 8:
            body = zlib.compress(body)
        elif comp == 32773:
            body = _packbits_literal(body)
        offsets.append(len(out))
        counts.append(len(body))
        out += body + b'\x00' * (len(body) % 2)
    layout = [(322, 4, [tile]), (323, 4, [tile]), (324, 4, offsets),
              (325, 4, counts)] if tile else \
        [(273, 4, offsets), (278, 4, [boxes[0][2]]), (279, 4, counts)]
    entries = sorted(layout + [
        (256, 4, [width]), (257, 4, [height]), (258, 3, [8 * itemsize] * spp),
        (259, 3, [comp]), (262, 3, [1 if spp == 1 else 2]), (277, 3, [spp]),
        (284, 3, [1]), (339, 3, [1] * spp)] +
        ([(317, 3, [2])] if predict else []))
    # values longer than 4 bytes go before the directory
    fields = []
    for tag, typ, values in entries:
        body = struct.pack(f'{e}{len(values)}{_FORMATS[typ]}', *values)
        if len(body) > 4:
            at = len(out)
            out += body + b'\x00' * (len(body) % 2)
            body = struct.pack(e + 'I', at)
        fields.append(struct.pack(e + 'HHI', tag, typ, len(values)) +
                      body.ljust(4, b'\x00'))
    struct.pack_into(e + 'I', out, 4, len(out))
    out += struct.pack(e + 'H', len(fields)) + b''.join(fields) + bytes(4)
    with open(path, 'wb') as f:
        f.write(out)


def _packbits_literal(body: bytes) -> bytes:
    """PackBits of ``body`` as literal runs of up to 128 bytes."""
    out = bytearray()
    for i in range(0, len(body), 128):
        run = body[i:i + 128]
        out.append(len(run) - 1)
        out += run
    return bytes(out)
