#!/usr/bin/env python
"""Short first check of the flash-attention kernels on a card: build
``pfst_tpu_torch/ops/csrc/flash_attention.cu`` with ``nvcc -Xptxas -v``
(registers and spills of every instantiation), then run each kernel once
per shape, compare it with the plain versions and print its median time.

For a first call after a kernel change, before ``chip_smoke.py``::

    python3 tools/flash_probe_torch.py

The errors and limits are ``chip_smoke.flash_errors``'s (phase 3c). q,
k, v are the strided views of a (B, N, 3, H, d) projection, as the ViT
block gives them. Exits 1 if a shape fails.
"""
import os.path as osp
import statistics
import subprocess
import sys
import tempfile
import time

import torch

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))
from chip_smoke import flash_errors  # noqa: E402
from pfst_tpu_torch.ops import (build, cuda_flash_attention,  # noqa: E402
                                cuda_flash_attention_bwd_dkv,
                                cuda_flash_attention_bwd_dq)

CASES = [(1, 2, 17, 64, torch.float32), (1, 12, 1025, 64, torch.float32),
         (1, 12, 1025, 64, torch.bfloat16), (2, 12, 1025, 64, torch.float32),
         (2, 3, 130, 32, torch.bfloat16), (1, 2, 300, 128, torch.float32),
         (8, 12, 1024, 64, torch.bfloat16), (8, 12, 4096, 64, torch.bfloat16)]


def ptxas_report():
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [build._nvcc(), *build.NVCC_FLAGS, '-Xptxas', '-v', '-o',
             osp.join(tmp, 'fa.so'),
             osp.join(build.CSRC_DIR, 'flash_attention.cu')],
            capture_output=True, text=True)
    print('ptxas rc', proc.returncode)
    for line in (proc.stdout + proc.stderr).splitlines():
        if any(w in line for w in ('registers', 'spill', 'error',
                                   'Compiling')):
            print(line)


def cuda_ms(fn, reps=10):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check(b, h, n, d, dtype):
    qkv = torch.randn(b, n, 3, h, d, device='cuda').to(dtype)
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    s = d**-0.5
    g = torch.randn(b, h, n, d, device='cuda').to(dtype)
    o, lse, err = flash_errors(q, k, v, g, s)
    di = (o.float() * g.float()).sum(-1).contiguous()
    t_fwd = cuda_ms(lambda: cuda_flash_attention(q, k, v, s))
    t_dkv = cuda_ms(lambda: cuda_flash_attention_bwd_dkv(q, k, v, g, lse, di,
                                                         s))
    t_dq = cuda_ms(lambda: cuda_flash_attention_bwd_dq(q, k, v, g, lse, di,
                                                       s))
    flops = 4 * b * h * n * n * d
    print(f'{(b, h, n, d)} {dtype}: fwd excess {err["fwd_excess"]:.2e} '
          f'(limit {err["fwd_limit"]:.1e}) lse {err["lse_rel_err"]:.2e}; '
          f'bwd excess {err["bwd_excess"]:.2e} (limit '
          f'{err["bwd_limit"]:.1e}) {"OK" if err["ok"] else "FAIL"}; ms fwd '
          f'{t_fwd:.3f} ({flops / t_fwd / 1e9:.1f} TFLOP/s) dkv {t_dkv:.3f} '
          f'dq {t_dq:.3f}', flush=True)
    return err['ok']


def main():
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip())
    print(torch.__version__, torch.version.cuda)
    ptxas_report()
    t0 = time.time()
    build.load('flash_attention')
    print(f'build {time.time() - t0:.1f}s')
    torch.manual_seed(0)
    ok = True
    for case in CASES:
        ok = check(*case) and ok
        torch.cuda.empty_cache()
    sys.exit(0 if ok else 1)


if __name__ == '__main__':
    main()
