#!/usr/bin/env python
"""A/B of the fused inference + pseudo-label program in fp32, bf16 and
int8 on the card (the counterpart of ``tools/int8_microbench.py``)::

    python tools/int8_microbench_torch.py [--config C] [--batch 24]
        [--patch 512] [--steps 5] [--reps 3]

The leaf config's DeepLabV3+ R50-D8 with seeded weights on a seeded
batch (``chip_smoke.py`` phase 6's program: logits, softmax, the
pseudo label, its probability and the share above 0.98): fp32 (TF32
convolutions, the default), bf16 autocast, and int8 (``ops.quant.
int8_inference``, dynamic activation scales) on the fp32 weights. Each
variant: the best of ``--reps`` rounds of ``--steps`` batches, timed
between synchronises, as s a batch and patches/s; for bf16 and int8 the
largest softmax gap to fp32 and the argmax agreement on the same batch.
Then one ``--request`` x ``--request`` image a variant (the serving
request of ``chip_smoke.py`` phase 4): the median of ``--steps`` calls
of ``inference_logits``, ms. One JSON line a variant.
"""
import argparse
import json
import os.path as osp
import statistics
import sys
import time

sys.path.insert(0, osp.join(osp.dirname(osp.abspath(__file__)), '..'))

LEAF = osp.join(osp.dirname(osp.abspath(__file__)), '..', 'configs', 'pfst',
                'pfst_pots_irrg2vaih_irrg_deeplabv3plus_r50-d8.py')


def parse_args(args=None):
    p = argparse.ArgumentParser(description='fp32 / bf16 / int8 A/B')
    p.add_argument('--config', default=LEAF)
    p.add_argument('--batch', type=int, default=24)
    p.add_argument('--patch', type=int, default=512)
    p.add_argument('--steps', type=int, default=5)
    p.add_argument('--reps', type=int, default=3)
    p.add_argument('--request', type=int, default=1024)
    p.add_argument('--device', default='cuda')
    return p.parse_args(args)


def main(args=None):
    args = parse_args(args)
    import contextlib

    import torch

    from pfst_tpu_torch.apis import init_segmentor
    from pfst_tpu_torch.ops.quant import int8_inference
    from pfst_tpu_torch.utils import Config

    cfg = Config.fromfile(args.config)
    model = init_segmentor(cfg, device=args.device)
    bf16_cfg = cfg.copy()
    bf16_cfg.model['dtype'] = 'bfloat16'
    bf16 = init_segmentor(bf16_cfg, device=args.device)
    bf16.load_state_dict(model.state_dict())
    device = next(model.parameters()).device
    gen = torch.Generator().manual_seed(1)
    img = torch.randn((args.batch, 3, args.patch, args.patch),
                      generator=gen).to(device)
    request = torch.randn((1, 3, args.request, args.request),
                          generator=gen).to(device)

    def sync():
        if device.type == 'cuda':
            torch.cuda.synchronize(device)

    @torch.inference_mode()
    def fused(m):
        logits, _ = m.encode_decode(img)
        probs = torch.softmax(logits.float(), dim=1)
        pseudo_prob, pseudo_label = probs.max(dim=1)
        quality = (pseudo_prob >= 0.98).float().mean()
        return probs, pseudo_label, quality

    variants = (('fp32', model, contextlib.nullcontext),
                ('bf16', bf16, contextlib.nullcontext),
                ('int8', model, int8_inference))
    rows, ref = [], None
    for name, m, ctx in variants:
        with ctx():
            out = fused(m)
            for _ in range(2):
                fused(m)
            best = None
            for _ in range(args.reps):
                sync()
                t0 = time.perf_counter()
                for _ in range(args.steps):
                    fused(m)
                sync()
                dt = (time.perf_counter() - t0) / args.steps
                best = dt if best is None else min(best, dt)
            times = []
            with torch.inference_mode():
                for i in range(args.steps + 1):
                    sync()
                    t0 = time.perf_counter()
                    m.inference_logits(request)
                    sync()
                    if i:     # the first call warms up
                        times.append((time.perf_counter() - t0) * 1e3)
        row = {'variant': name, 's_per_batch': best,
               'patches_per_sec': args.batch / best,
               'request_ms': statistics.median(times)}
        if ref is None:
            ref = out
        else:
            row['max_softmax_gap'] = float((out[0] - ref[0]).abs().max())
            row['argmax_agreement'] = float(
                (out[1] == ref[1]).float().mean())
            row['speedup_vs_fp32'] = rows[0]['s_per_batch'] / best
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


if __name__ == '__main__':
    main()
