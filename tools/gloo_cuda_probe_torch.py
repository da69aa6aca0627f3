#!/usr/bin/env python
"""Which collectives gloo runs on CUDA tensors, on this machine's card.

For each collective the sharded modes use
(``pfst_tpu_torch/parallel/comm.py``) it starts two gloo ranks that share
``cuda:0`` (as ``chip_smoke.py``'s phases 22 and 23 run them) and runs the
collective on CUDA tensors of fp32 and bf16, checking the result against
the same collective on CPU tensors. gloo may abort the process on a CUDA
tensor it cannot take (a TCP write of a device pointer), so each
collective runs in a pair of its own, and a pair that dies marks it
refused. Prints one line a collective and dtype and, last, a JSON object
``{"supported": [...], "refused": {...}}``; ``comm.STAGED_ON_GLOO`` lists
what it refuses::

    python3 tools/gloo_cuda_probe_torch.py

A probe: an exception here is its answer, and the port stages the
operations it names up front instead of catching them.
"""
import datetime
import json
import os
import sys
import tempfile
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

OPS = ('all_reduce', 'broadcast', 'all_gather', 'reduce_scatter',
       'all_to_all', 'all_to_all_uneven', 'send_recv')


def _run(op, rank, dev, dtype):
    x = (torch.arange(8, dtype=torch.float32) + 10 * rank).to(dtype)
    x = x.to(dev)
    if op == 'all_reduce':
        dist.all_reduce(x)
        return x
    if op == 'broadcast':
        dist.broadcast(x, 0)
        return x
    if op == 'all_gather':
        out = x.new_empty(16)
        dist.all_gather_into_tensor(out, x)
        return out
    if op == 'reduce_scatter':
        out = x.new_empty(4)
        dist.reduce_scatter_tensor(out, x)
        return out
    if op == 'all_to_all':
        out = x.new_empty(8)
        dist.all_to_all_single(out, x)
        return out
    if op == 'all_to_all_uneven':
        splits_in = [3, 5] if rank == 0 else [2, 6]
        splits_out = [3, 2] if rank == 0 else [5, 6]
        out = x.new_empty(sum(splits_out))
        dist.all_to_all_single(out, x, splits_out, splits_in)
        return out
    buf = x.new_empty(8)
    ops = [dist.isend(x, 1 - rank), dist.irecv(buf, 1 - rank)]
    for o in ops:
        o.wait()
    return buf


def rank_main(rank, store, out, op):
    torch.cuda.set_device(0)
    dist.init_process_group('gloo', init_method=f'file://{store}',
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=60))
    for dtype in (torch.float32, torch.bfloat16):
        key = f'{op} {str(dtype).split(".")[1]}'
        want = _run(op, rank, 'cpu', dtype)
        try:
            got = _run(op, rank, 'cuda', dtype)
            torch.cuda.synchronize()
            result = 'ok' if torch.equal(got.cpu(), want) else \
                'wrong result'
        except Exception as e:  # noqa: BLE001 - the probe's answer
            result = f'{type(e).__name__}: {str(e)[:160]}'
        if rank == 0:
            with open(out, 'a') as f:
                f.write(json.dumps([key, result]) + '\n')
        dist.barrier()
    dist.destroy_process_group()


def main():
    if not torch.cuda.is_available():
        print('no CUDA device', file=sys.stderr)
        return 1
    d = tempfile.mkdtemp()
    out = os.path.join(d, 'report.jsonl')
    report = {}
    for op in OPS:
        try:
            mp.spawn(rank_main, args=(os.path.join(d, f'store_{op}'), out,
                                      op), nprocs=2)
        except Exception as e:  # noqa: BLE001 - a rank died: refused
            report[f'{op} (process)'] = \
                f'died: {type(e).__name__}: {str(e).strip()[-160:]}'
    with open(out) as f:
        for line in f:
            key, result = json.loads(line)
            report[key] = result
    for op in OPS:
        for dt in ('float32', 'bfloat16'):
            report.setdefault(f'{op} {dt}', 'not reached (the pair died)')
    for k, v in report.items():
        print(f'{k}: {v}')
    bad = {k.split()[0] for k, v in report.items() if v != 'ok'}
    supported = sorted({k.split()[0] for k in report} - bad)
    refused = {k: v for k, v in report.items() if v != 'ok'}
    print(json.dumps({'torch': torch.__version__, 'supported': supported,
                      'refused': refused}))
    return 0


if __name__ == '__main__':
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        sys.exit(1)
