"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``ops/csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds and needs no ninja). The library lands in
``<repo>/build/pfst_tpu_torch/`` under a name keyed by a hash of the
source, of every header in ``csrc/`` and of the flags, so an edited
source or header is rebuilt and an unchanged one is reused. A failed build raises: nothing falls back to the plain
PyTorch versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import os.path as osp
import shutil
import subprocess
import tempfile
import threading

_OPS_DIR = osp.dirname(osp.abspath(__file__))
CSRC_DIR = osp.join(_OPS_DIR, 'csrc')
BUILD_DIR = osp.join(osp.dirname(osp.dirname(_OPS_DIR)), 'build',
                     'pfst_tpu_torch')
NVCC_FLAGS = ('-O3', '-std=c++17', '-gencode', 'arch=compute_90a,code=sm_90a',
              '-Xcompiler', '-fPIC', '-shared')

_libs = {}
_lock = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    candidates = [osp.join(CUDA_HOME, 'bin', 'nvcc')] if CUDA_HOME else []
    found = shutil.which('nvcc')
    if found:
        candidates.append(found)
    for path in candidates:
        if osp.isfile(path):
            return path
    raise RuntimeError('nvcc not found: the CUDA kernels of pfst_tpu_torch '
                       'are built from source at first use and need the '
                       'CUDA toolkit (set CUDA_HOME or put nvcc on PATH)')


def library_path(name: str) -> str:
    """Where ``csrc/<name>.cu`` is built, keyed by the source, every
    ``csrc/*.cuh`` (a source may include any of them) and the flags."""
    digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith('.cuh'))
    for fname in [f'{name}.cu', *headers]:
        with open(osp.join(CSRC_DIR, fname), 'rb') as f:
            digest.update(fname.encode() + b'\0' + f.read() + b'\0')
    return osp.join(BUILD_DIR, f'{name}_{digest.hexdigest()[:16]}.so')


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library is already built;
    return the library's path."""
    out = library_path(name)
    if osp.isfile(out):
        return out
    os.makedirs(osp.dirname(out), exist_ok=True)
    # compile to a private file and rename, so that concurrent builders
    # never load a half-written library
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=osp.dirname(out))
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, '-o', tmp, osp.join(CSRC_DIR, f'{name}.cu')]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f'building {name}.cu failed '
                               f'(exit {proc.returncode}):\n{" ".join(cmd)}\n'
                               f'{proc.stdout}{proc.stderr}')
        os.replace(tmp, out)
    finally:
        if osp.exists(tmp):
            os.remove(tmp)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(build(name))
        return _libs[name]
