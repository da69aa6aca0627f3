"""ctypes loader of the host-side data-pipeline kernels (port of
``pfst_tpu/native/hostaug.py``): the fused HSV round trip, PNG
unfiltering, OpenCV-exact resizes (uint8, and float32 bilinear) and the
TIFF LZW and PackBits codecs of ``hostaug.cc``.

``hostaug.cc`` is compiled by ``g++`` at first use into
``<repo>/build/pfst_tpu_torch/`` under a name keyed by a hash of the
source and the flags, as ``ops/build.py`` builds the CUDA sources. These
kernels are the port's only route for what they do: a failed build
raises, nothing falls back to another library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import os.path as osp
import subprocess
import tempfile
import threading

import numpy as np

from ..ops.build import BUILD_DIR

_SRC = osp.join(osp.dirname(osp.abspath(__file__)), 'hostaug.cc')
GXX_FLAGS = ('-O3', '-ffp-contract=off', '-shared', '-fPIC')
_lock = threading.Lock()
_lib = None

_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I16P = ctypes.POINTER(ctypes.c_int16)
_F32P = ctypes.POINTER(ctypes.c_float)
_I64 = ctypes.c_int64
_SIGNATURES = {
    'hsv_modify_u8': ([_U8P, _U8P, _I64, _U8P, _U8P], None),
    'bgr2hsv_u8': ([_U8P, _U8P, _I64], None),
    'hsv2bgr_u8': ([_U8P, _U8P, _I64], None),
    'png_unfilter': ([_U8P, _U8P, _I64, _I64, _I64], ctypes.c_int),
    'resize_linear_u8': ([_U8P, _I64, _I64, _I64, _U8P, _I64, _I64, _I32P,
                          _I16P, _I32P, _I16P], None),
    'resize_nearest_u8': ([_U8P, _I64, _I64, _U8P, _I64, _I64, _I32P,
                           _I32P], None),
    'resize_linear_f32': ([_F32P, _I64, _I64, _F32P, _I64, _I64, _I32P,
                           _I32P, _F32P, _I32P, _I32P, _F32P], None),
    'tiff_lzw_decode': ([_U8P, _I64, _U8P, _I64], _I64),
    'tiff_lzw_encode': ([_U8P, _I64, _U8P, _I64], _I64),
    'packbits_decode': ([_U8P, _I64, _U8P, _I64], _I64),
}


def library_path() -> str:
    with open(_SRC, 'rb') as f:
        digest = hashlib.sha256(' '.join(GXX_FLAGS).encode() + f.read())
    return osp.join(BUILD_DIR, f'hostaug_{digest.hexdigest()[:16]}.so')


def _build() -> str:
    out = library_path()
    if osp.isfile(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    cmd = ['g++', *GXX_FLAGS, '-o', tmp, _SRC]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f'building hostaug.cc failed (exit '
                               f'{proc.returncode}):\n{" ".join(cmd)}\n'
                               f'{proc.stdout}{proc.stderr}')
        os.replace(tmp, out)
    finally:
        if osp.exists(tmp):
            os.remove(tmp)
    return out


def lib() -> ctypes.CDLL:
    """The loaded library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            loaded = ctypes.CDLL(_build())
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(loaded, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = loaded
        return _lib


def _ptr(arr, ctype=_U8P):
    return arr.ctypes.data_as(ctype)


def _u8(img) -> np.ndarray:
    return np.ascontiguousarray(img, np.uint8)


def _hsv_image(img) -> np.ndarray:
    img = _u8(img)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f'expected an (H, W, 3) BGR image, got {img.shape}')
    return img


def hsv_modify(img, sat_lut=None, hue_lut=None) -> np.ndarray:
    """Fused BGR -> HSV -> {S, H LUT} -> BGR on an (H, W, 3) uint8
    image; either 256-entry LUT may be None (identity)."""
    img = _hsv_image(img)
    luts = [None if t is None else _u8(t) for t in (sat_lut, hue_lut)]
    for t in luts:
        if t is not None and t.shape != (256,):
            raise ValueError(f'a LUT has 256 entries, got {t.shape}')
    out = np.empty_like(img)
    lib().hsv_modify_u8(_ptr(img), _ptr(out), img.shape[0] * img.shape[1],
                        *[None if t is None else _ptr(t) for t in luts])
    return out


def bgr2hsv(img) -> np.ndarray:
    img = _hsv_image(img)
    out = np.empty_like(img)
    lib().bgr2hsv_u8(_ptr(img), _ptr(out), img.shape[0] * img.shape[1])
    return out


def hsv2bgr(img) -> np.ndarray:
    img = _hsv_image(img)
    out = np.empty_like(img)
    lib().hsv2bgr_u8(_ptr(img), _ptr(out), img.shape[0] * img.shape[1])
    return out


def png_unfilter(data: bytes, height: int, stride: int,
                 bpp: int) -> np.ndarray:
    """The (height, stride) bytes of a PNG image's decompressed IDAT
    stream ``data`` (each row a filter byte and ``stride`` bytes) with
    the row filters undone."""
    buf = np.frombuffer(data, np.uint8)
    if buf.size != height * (stride + 1):
        raise ValueError(f'PNG data holds {buf.size} bytes, expected '
                         f'{height} rows of 1 + {stride}')
    out = np.empty((height, stride), np.uint8)
    if lib().png_unfilter(_ptr(buf), _ptr(out), height, stride, bpp):
        raise ValueError('PNG row with an unknown filter type')
    return out


def resize_linear(img: np.ndarray, size_hw, xofs, alpha, yofs,
                  beta) -> np.ndarray:
    """cv2.resize(INTER_LINEAR) arithmetic on an (H, W[, C]) uint8 image
    given OpenCV's offsets and fixed-point weights: ``xofs`` (dw,) int32,
    ``alpha`` (dw, 2) int16, ``yofs`` (dh, 2) int32, ``beta`` (dh, 2)
    int16."""
    img = _u8(img)
    h, w = img.shape[:2]
    cn = 1 if img.ndim == 2 else img.shape[2]
    dh, dw = size_hw
    arrays = [np.ascontiguousarray(a, t) for a, t in (
        (xofs, np.int32), (alpha, np.int16), (yofs, np.int32),
        (beta, np.int16))]
    if arrays[0].shape != (dw,) or arrays[1].shape != (dw, 2) or \
            arrays[2].shape != (dh, 2) or arrays[3].shape != (dh, 2):
        raise ValueError('resize coefficients do not match the size')
    if not (0 <= arrays[0].min() and arrays[0].max() < w and
            0 <= arrays[2].min() and arrays[2].max() < h):
        raise ValueError('resize offsets out of the image')
    out = np.empty((dh, dw) + img.shape[2:], np.uint8)
    lib().resize_linear_u8(
        _ptr(img), h, w, cn, _ptr(out), dh, dw, _ptr(arrays[0], _I32P),
        _ptr(arrays[1], _I16P), _ptr(arrays[2], _I32P),
        _ptr(arrays[3], _I16P))
    return out


def resize_nearest(img: np.ndarray, xofs, yofs) -> np.ndarray:
    """``img[yofs][:, xofs]`` of an (H, W[, C]) uint8 image."""
    img = _u8(img)
    h, w = img.shape[:2]
    cn = 1 if img.ndim == 2 else img.shape[2]
    xofs = np.ascontiguousarray(xofs, np.int32)
    yofs = np.ascontiguousarray(yofs, np.int32)
    if not (0 <= xofs.min() and xofs.max() < w and 0 <= yofs.min()
            and yofs.max() < h):
        raise ValueError('resize offsets out of the image')
    out = np.empty((yofs.size, xofs.size) + img.shape[2:], np.uint8)
    lib().resize_nearest_u8(_ptr(img), w, cn, _ptr(out), yofs.size,
                            xofs.size, _ptr(xofs, _I32P), _ptr(yofs, _I32P))
    return out


def resize_linear_f32(img: np.ndarray, cols, rows) -> np.ndarray:
    """cv2.resize(INTER_LINEAR) arithmetic on an (H, W[, C]) float32 image
    of at least two rows and columns: ``cols`` and ``rows`` are each
    (first source index (n,) int32, second (n,) int32, the second's
    weight (n,) float32), from OpenCV's coordinate map."""
    img = np.ascontiguousarray(img, np.float32)
    h, w = img.shape[:2]
    cn = 1 if img.ndim == 2 else img.shape[2]
    x0, x1, fx = [np.ascontiguousarray(a, t) for a, t in
                  zip(cols, (np.int32, np.int32, np.float32))]
    y0, y1, fy = [np.ascontiguousarray(a, t) for a, t in
                  zip(rows, (np.int32, np.int32, np.float32))]
    if min(h, w) < 2:
        raise ValueError('the float32 resize takes images of at least two '
                         'rows and columns')
    if not (0 <= min(x0.min(), x1.min()) and max(x0.max(), x1.max()) < w
            and 0 <= min(y0.min(), y1.min())
            and max(y0.max(), y1.max()) < h):
        raise ValueError('resize offsets out of the image')
    out = np.empty((y0.size, x0.size) + img.shape[2:], np.float32)
    lib().resize_linear_f32(
        _ptr(img, _F32P), w, cn, _ptr(out, _F32P), y0.size, x0.size,
        _ptr(x0, _I32P), _ptr(x1, _I32P), _ptr(fx, _F32P), _ptr(y0, _I32P),
        _ptr(y1, _I32P), _ptr(fy, _F32P))
    return out


def _codec(name: str, data: bytes, capacity: int) -> np.ndarray:
    buf = np.frombuffer(data, np.uint8)
    out = np.empty(capacity, np.uint8)
    n = getattr(lib(), name)(_ptr(buf), buf.size, _ptr(out), capacity)
    if n < 0:
        raise ValueError(f'{name}: corrupt data')
    if n > capacity:
        raise ValueError(f'{name}: {n} bytes do not fit in {capacity}')
    return out[:n]


def lzw_decode(data: bytes, size: int) -> np.ndarray:
    """The first ``size`` bytes (or fewer, where the data ends) that the
    TIFF LZW stream ``data`` decodes to."""
    return _codec('tiff_lzw_decode', data, size)


def lzw_encode(data: bytes) -> bytes:
    """``data`` as one TIFF LZW stream (Clear code first, EOI last)."""
    # at most one 12-bit code a byte, and a Clear code every 3836 codes
    return _codec('tiff_lzw_encode', data,
                  len(data) * 3 // 2 + len(data) // 1024 + 16).tobytes()


def packbits_decode(data: bytes, size: int) -> np.ndarray:
    """The first ``size`` bytes that the PackBits stream ``data`` decodes
    to."""
    return _codec('packbits_decode', data, size)
