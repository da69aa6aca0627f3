"""Environment report (port of ``pfst_tpu/utils/collect_env.py``; mirrors
``rsiseg/utils/collect_env.py``, which the reference logs at the start of
training): Python, the versions of torch, numpy and triton, the CUDA
build, ``nvcc``, and each card's name and power limit.

Run ``python -m pfst_tpu_torch.utils.collect_env`` to print it.
"""
from __future__ import annotations

import importlib
import shutil
import subprocess
import sys
from collections import OrderedDict

NVIDIA_SMI_QUERY = ['nvidia-smi', '--query-gpu=name,power.limit',
                    '--format=csv,noheader']


def _run(cmd) -> str:
    """The output of ``cmd``, or why there is none."""
    if shutil.which(cmd[0]) is None:
        return 'not available'
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    if proc.returncode != 0:
        return f'failed ({proc.returncode}): {proc.stderr.strip()}'
    return proc.stdout.strip()


def _nvcc() -> str:
    import os.path as osp
    for nvcc in ('nvcc', '/usr/local/cuda/bin/nvcc'):
        if shutil.which(nvcc) or osp.isfile(nvcc):
            out = _run([nvcc, '--version'])
            return out.splitlines()[-1] if out else out
    return 'not available'


def collect_env() -> 'OrderedDict[str, str]':
    import torch
    env = OrderedDict()
    env['sys.platform'] = sys.platform
    env['Python'] = sys.version.replace('\n', '')
    for mod in ('torch', 'numpy', 'triton'):
        try:
            env[mod] = getattr(importlib.import_module(mod), '__version__',
                               'unknown')
        except ImportError:
            env[mod] = 'not available'
    env['CUDA build'] = str(torch.version.cuda)
    env['CUDA available'] = str(torch.cuda.is_available())
    if torch.cuda.is_available():
        env['devices'] = ', '.join(
            f'cuda:{i} {torch.cuda.get_device_name(i)}'
            for i in range(torch.cuda.device_count()))
        env['cuDNN'] = str(torch.backends.cudnn.version())
    env['NVCC'] = _nvcc()
    env['GPU name, power limit'] = _run(NVIDIA_SMI_QUERY).replace('\n', '; ')
    return env


def main():
    for name, val in collect_env().items():
        print(f'{name}: {val}')


if __name__ == '__main__':
    main()
