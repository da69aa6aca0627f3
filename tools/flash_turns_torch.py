#!/usr/bin/env python
"""Time the three flash-attention kernels of several checkouts in turns
on one card, to compare two versions of ``flash_attention.cu`` within one
call (noise between calls and cards is larger than most changes).

Every checkout's library is built first, all ``nvcc`` runs at once (each
into its own ``build/``); then each run is its own process, started in
its checkout's directory, which draws q, k, v (the ViT block's strided
views of one (B, N, 3, H, d) projection) and dL/dO from one seed through
that checkout's ``chip_smoke._flash_inputs``, and times the forward,
dK/dV and dQ kernels in fp32 and bf16 with that checkout's
``chip_smoke.graph_ms`` (device time: ten launches in a CUDA graph, per
launch). It prints one ``TURN`` JSON line per run and a summary with each
label's device ms per kernel and type, in run order. For example, with
the parent unpacked by ``git archive`` into a gitignored directory::

    python3 tools/flash_turns_torch.py parent=build/parent change=. \\
        change=. parent=build/parent [--shape 2,12,1025,64]

Exits 1 if a run fails.
"""
import argparse
import concurrent.futures
import json
import os.path as osp
import subprocess
import sys

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
BUILD = ('from pfst_tpu_torch.ops import build; '
         "print(build.build('flash_attention'))")
CHILD = r'''
import json
import sys
import torch
sys.path.insert(0, '.')
import chip_smoke as cs
from pfst_tpu_torch.ops import (cuda_flash_attention,
                                cuda_flash_attention_bwd_dkv,
                                cuda_flash_attention_bwd_dq)
shape = tuple(int(x) for x in sys.argv[1].split(','))
gen = torch.Generator().manual_seed(4)
out = {}
for dtype in (torch.float32, torch.bfloat16):
    q, k, v = cs._flash_inputs(shape, dtype, 'qkv', gen)
    g = torch.randn(shape, generator=gen).to('cuda', dtype)
    s = shape[-1]**-0.5
    o, lse = cuda_flash_attention(q, k, v, s)
    di = (o.float() * g.float()).sum(-1).contiguous()
    out[str(dtype).split('.')[-1]] = {
        'fwd': cs.graph_ms(lambda: cuda_flash_attention(q, k, v, s)),
        'dkv': cs.graph_ms(lambda: cuda_flash_attention_bwd_dkv(
            q, k, v, g, lse, di, s)),
        'dq': cs.graph_ms(lambda: cuda_flash_attention_bwd_dq(
            q, k, v, g, lse, di, s))}
print('TURN ' + json.dumps(out), flush=True)
'''


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('runs', nargs='+', help='label=checkout directory')
    parser.add_argument('--shape', default='2,12,1025,64',
                        help='B,H,N,d of q, k, v (default: the ViT '
                        'training shape)')
    args = parser.parse_args(argv)
    runs = [r.split('=', 1) for r in args.runs]
    dirs = sorted({osp.abspath(osp.join(ROOT, d)) for _, d in runs})
    with concurrent.futures.ThreadPoolExecutor(len(dirs)) as pool:
        built = list(pool.map(lambda d: subprocess.run(
            [sys.executable, '-c', BUILD], cwd=d, capture_output=True,
            text=True), dirs))
    for d, proc in zip(dirs, built):
        print(f'[build] {d}: rc {proc.returncode} {proc.stdout.strip()}'
              f'{proc.stderr[-2000:] if proc.returncode else ""}', flush=True)
        if proc.returncode:
            return 1
    summary = []
    for label, d in runs:
        proc = subprocess.run([sys.executable, '-c', CHILD, args.shape],
                              cwd=osp.join(ROOT, d), capture_output=True,
                              text=True)
        line = next((x for x in proc.stdout.splitlines()
                     if x.startswith('TURN ')), None)
        if proc.returncode or line is None:
            print(f'[{label}] failed (rc {proc.returncode}):\n'
                  f'{proc.stdout[-2000:]}{proc.stderr[-4000:]}', flush=True)
            return 1
        ms = json.loads(line[5:])
        print(f'[{label}] {d} {args.shape}: {json.dumps(ms)}', flush=True)
        summary.append({'label': label, 'dir': d, 'device_ms': ms})
    print('SUMMARY ' + json.dumps({'shape': args.shape, 'runs': summary}),
          flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
