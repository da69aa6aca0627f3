#!/usr/bin/env python
"""Trace supervised steps of ``configs/_base_/models`` defs on the card
and print where the device time goes.

Each def named is trained as ``chip_smoke.py`` phase 20 trains it (the
config as it stands, seeded weights, AdamW, batch 2 of synthetic crops,
``chip_smoke._vit_train_setup`` and ``_vit_batch``): ``--warmup`` steps,
then ``--steps`` steps under ``torch.profiler`` with CUDA activity. It
prints one ``TRACE`` JSON line a def: the wall ms a step, the device ms
a step of every kernel, copy and set together, the share of the traced
window the device was busy, and the ``--top`` device ops by ms a step
(names cut to 100 characters). For example::

    python3 tools/trace_step_torch.py pspnet_unet_s5-d16 fcn_unet_s5-d16

Needs the card.
"""
import argparse
import collections
import json
import os
import os.path as osp
import sys
import tempfile
import time

import torch

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
_DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')


def _device_ops(path, steps):
    """(ms a step by op name, busy ms a step, window ms) of a Chrome
    trace's device events."""
    with open(path) as f:
        events = json.load(f)['traceEvents']
    events = [e for e in events if e.get('cat') in _DEVICE_CATS]
    ms = collections.Counter()
    spans = []
    for e in events:
        ms[e['name'][:100]] += e['dur'] / 1e3 / steps
        spans.append((e['ts'], e['ts'] + e['dur']))
    spans.sort()
    busy, end = 0.0, None
    for a, b in spans:      # the union of the spans
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    window = spans[-1][1] - spans[0][0]
    return ms, busy / 1e3 / steps, window / 1e3


def trace(name, hw, steps, warmup, top, dtype):
    import chip_smoke as cs
    cfg = cs.model_config(osp.join(cs.MODEL_DEFS, f'{name}.py'))
    _, state, step = cs._vit_train_setup(cfg)
    state.student.dtype = dtype
    batches = [cs._vit_batch(cfg, 4000 + i, hw)
               for i in range(warmup + steps)]
    gen = torch.Generator().manual_seed(3)
    for batch in batches[:warmup]:
        state, _ = step(state, batch, gen)
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.time()
        for batch in batches[warmup:]:
            state, _ = step(state, batch, gen)
        torch.cuda.synchronize()
        wall = (time.time() - t0) * 1e3 / steps
    fd, path = tempfile.mkstemp(suffix='.json')
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        ms, busy, window = _device_ops(path, steps)
    finally:
        os.remove(path)
    if not ms:
        raise RuntimeError(f'{name}: the trace holds no device event')
    return dict(name=name, dtype=str(dtype).removeprefix('torch.'),
                hw=list(hw), wall_ms=round(wall, 3),
                device_ms=round(sum(ms.values()), 3),
                busy_share=round(busy * steps / window, 4),
                top=[[n, round(v, 3)] for n, v in ms.most_common(top)])


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('defs', nargs='+',
                        help='names of configs/_base_/models/*.py defs')
    parser.add_argument('--hw', type=int, default=512)
    parser.add_argument('--steps', type=int, default=2)
    parser.add_argument('--warmup', type=int, default=3)
    parser.add_argument('--top', type=int, default=8)
    parser.add_argument('--dtype', choices=('float32', 'bfloat16'),
                        default='float32')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit('no CUDA device: this tool traces the card')
    sys.path.insert(0, ROOT)
    for name in args.defs:
        out = trace(name, (args.hw, args.hw), args.steps, args.warmup,
                    args.top, getattr(torch, args.dtype))
        print('TRACE ' + json.dumps(out), flush=True)


if __name__ == '__main__':
    main()
