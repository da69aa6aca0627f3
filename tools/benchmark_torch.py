#!/usr/bin/env python
"""Inference FPS benchmark of the PyTorch port (the counterpart of
``tools/benchmark.py``; rsiseg's ``tools/benchmark.py`` protocol)::

    python tools/benchmark_torch.py <config> [checkpoint] --num-images 200 \\
        [--warmup 5] [--repeat-times 1] [--work-dir D]

One seeded random image of the config's ``crop_size`` (512^2 without
one), labelled ``--num-images`` times after ``--warmup`` runs, the clock
read after a synchronise at both ends; ``--repeat-times`` such rounds.
Prints each round's fps and, last, the JSON summary ``{"fps",
"fps_std", "num_images"}``, also written to ``<work-dir>/benchmark.json``.
Runs on the card unless ``--device cpu``.
"""
import argparse
import json
import os.path as osp
import sys
import time

sys.path.insert(0, osp.join(osp.dirname(osp.abspath(__file__)), '..'))

import numpy as np  # noqa: E402

from pfst_tpu_torch.utils import Config, DictAction  # noqa: E402


def parse_args(args=None):
    parser = argparse.ArgumentParser(description='benchmark a model')
    parser.add_argument('config')
    parser.add_argument('checkpoint', nargs='?', default=None)
    parser.add_argument('--log-interval', type=int, default=50)
    parser.add_argument('--num-images', type=int, default=200)
    parser.add_argument('--warmup', type=int, default=5)
    parser.add_argument('--work-dir', default=None)
    parser.add_argument('--repeat-times', type=int, default=1)
    parser.add_argument('--cfg-options', nargs='+', action=DictAction)
    parser.add_argument('--device', default='cuda',
                        help='torch device (default: the card)')
    return parser.parse_args(args)


def main(args=None):
    args = parse_args(args)
    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_dict(args.cfg_options)
    import torch

    from pfst_tpu_torch.apis import init_segmentor

    model = init_segmentor(cfg, args.checkpoint, device=args.device)
    device = next(model.parameters()).device
    crop = cfg.get('crop_size') or (512, 512)
    img = torch.from_numpy(np.random.RandomState(0).randn(
        1, 3, crop[0], crop[1]).astype(np.float32)).to(device)

    def sync():
        if device.type == 'cuda':
            torch.cuda.synchronize(device)

    @torch.inference_mode()
    def infer(img):
        probs, _ = model.inference(img)
        return probs.argmax(dim=1)

    results = []
    for _ in range(args.repeat_times):
        for _ in range(args.warmup):
            infer(img)
        sync()
        t0 = time.perf_counter()
        for i in range(args.num_images):
            infer(img)
            if (i + 1) % args.log_interval == 0:
                sync()
                print(f'Done image [{i + 1:<3}/ {args.num_images}], fps: '
                      f'{(i + 1) / (time.perf_counter() - t0):.2f} img / s')
        sync()
        fps = args.num_images / (time.perf_counter() - t0)
        results.append(fps)
        print(f'Overall fps: {fps:.2f} img/s')
    summary = {'fps': float(np.mean(results)),
               'fps_std': float(np.std(results)),
               'num_images': args.num_images}
    print(json.dumps(summary))
    if args.work_dir:
        with open(osp.join(args.work_dir, 'benchmark.json'), 'w') as f:
            json.dump(summary, f)
    return summary


if __name__ == '__main__':
    main()
