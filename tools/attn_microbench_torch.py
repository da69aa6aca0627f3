#!/usr/bin/env python
"""A/B on the card: the plain attention against the port's flash kernels,
with torch's ``scaled_dot_product_attention`` as a yardstick (port of
``tools/attn_microbench.py``).

Rows as in the JAX file: ViT-family shapes (ViT/BEiT/MAE-base at 512^2
crops, patch 16: N = 1024 tokens, 12 heads x 64), bf16, ``fwd`` and
``fwd+bwd`` (the gradient of ``sum(o^2)`` with respect to q, k, v), fresh
inputs every rep. Columns: ``naive`` is ``ops.torch_attention``, ``flash``
is ``ops.attention`` (the kernels ``csrc/flash_attention.cu``), ``library``
is SDPA, timed here for comparison only (the port never calls it). Each
cell is ``best/median`` ms over ``reps`` runs, each timed with CUDA events
after ``warmup`` runs.

Run on a card, from the root of a checkout::

    python3 tools/attn_microbench_torch.py [--batch 8] [--seq 1024 4096]

It raises when there is no card; with ``--device cpu`` it times the
plain version only (on the CPU there is no flash kernel to time).
"""
import argparse
import os.path as osp
import statistics
import sys
import time

import torch
import torch.nn.functional as F

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))
from pfst_tpu_torch.ops import attention, torch_attention  # noqa: E402
from pfst_tpu_torch.utils.misc import resolve_device  # noqa: E402


def _library(q, k, v, scale):
    return F.scaled_dot_product_attention(q, k, v, scale=scale)


FNS = {'naive': torch_attention, 'flash': attention, 'library': _library}


def _elapsed_ms(run, args, device):
    if device.type != 'cuda':
        t0 = time.perf_counter()
        run(*args)
        return (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def bench(fn, shape, reps=8, warmup=2, grad=False, device='cuda', seed=0):
    """(best, median) ms of ``fn(q, k, v, scale)`` (or of its gradient
    with ``grad``) on fresh bf16 inputs of ``shape`` every run."""
    device = resolve_device(device)
    scale = shape[-1]**-0.5
    gen = torch.Generator(device=device).manual_seed(seed)

    def fresh():
        return [torch.randn(shape, generator=gen, device=device,
                            dtype=torch.bfloat16).requires_grad_(grad)
                for _ in range(3)]

    if grad:
        def run(q, k, v):
            loss = (fn(q, k, v, scale).float()**2).sum()
            return torch.autograd.grad(loss, (q, k, v))
    else:
        def run(q, k, v):
            with torch.no_grad():
                return fn(q, k, v, scale)

    for _ in range(warmup):
        run(*fresh())
    times = [_elapsed_ms(run, fresh(), device) for _ in range(reps)]
    return min(times), statistics.median(times)


def bench_rows(batch=(8,), seq=(1024, 4096), heads=12, head_dim=64, reps=8,
               device='cuda'):
    """The table's rows as dicts; times are ``best/median`` ms strings
    and, per column, the median in ``<column>_ms``."""
    device = resolve_device(device)
    names = list(FNS) if device.type == 'cuda' else ['naive']
    rows = []
    for b in batch:
        for n in seq:
            shape = (b, heads, n, head_dim)
            for grad in (False, True):
                row = {'shape': shape, 'mode': 'fwd+bwd' if grad else 'fwd'}
                for name in names:
                    best, med = bench(FNS[name], shape, reps=reps, grad=grad,
                                      device=device)
                    row[name] = f'{best:.3f}/{med:.3f} ms'
                    row[name + '_ms'] = med
                if 'flash_ms' in row:
                    row['speedup'] = f"{row['naive_ms'] / row['flash_ms']:.2f}x"
                    row['flash_over_library'] = \
                        f"{row['flash_ms'] / row['library_ms']:.2f}x"
                rows.append(row)
                print(row, flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--batch', type=int, nargs='*', default=[8])
    ap.add_argument('--seq', type=int, nargs='*', default=[1024, 4096])
    ap.add_argument('--heads', type=int, default=12)
    ap.add_argument('--head-dim', type=int, default=64)
    ap.add_argument('--reps', type=int, default=8)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == 'cuda':
        print(f'device={torch.cuda.get_device_name(device)}')
    else:
        print(f'device={device}: naive only; flash and library need a card')
    return bench_rows(args.batch, args.seq, args.heads, args.head_dim,
                      args.reps, device)


if __name__ == '__main__':
    main()
