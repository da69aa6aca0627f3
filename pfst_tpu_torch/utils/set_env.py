"""Process setup (port of ``pfst_tpu/utils/set_env.py``; mirrors
``rsiseg/utils/set_env.py:11``). The JAX file tunes glibc's allocator,
keeps cv2 single-threaded and points XLA at a compilation cache; the port
has no cv2 and no XLA, so what is left is the allocator tuning."""
from __future__ import annotations

import ctypes
import os

_state = {'tuned': False}


def tune_malloc() -> bool:
    """glibc buffer reuse for the data path (``PFST_MALLOC_TUNE=0`` opts
    out): at most 4 arenas, and mmap and trim thresholds of 1 GiB, so the
    loader's per-batch sample buffers stay in the heap and are reused
    instead of being returned to the system and faulted in again (the
    JAX file's measurement: collate stalls of 3-11 s at batch 16 on a
    host whose fresh pages fault in at ~35 MB/s). Returns whether the
    settings are in place."""
    if os.environ.get('PFST_MALLOC_TUNE', '1') == '0':
        return False
    if _state['tuned']:
        return True
    try:
        libc = ctypes.CDLL('libc.so.6', use_errno=True)
    except OSError:
        return False
    arenas = max(1, min(4, os.cpu_count() or 1))
    libc.mallopt(-8, arenas)     # M_ARENA_MAX
    libc.mallopt(-3, 1 << 30)    # M_MMAP_THRESHOLD
    libc.mallopt(-1, 1 << 30)    # M_TRIM_THRESHOLD
    _state['tuned'] = True
    return True


def setup_environment(cfg=None):
    """Idempotent process setup; the CLIs call it first. ``cfg`` is
    accepted for the JAX signature."""
    tune_malloc()


# the reference's name
setup_multi_processes = setup_environment
