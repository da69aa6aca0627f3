#!/usr/bin/env python
"""Calibrate static int8 activation scales on a few validation images
(the counterpart of ``tools/calibrate_int8.py``)::

    python tools/calibrate_int8_torch.py CONFIG [CKPT] -o scales.json -n 8
    python tools/test_torch.py CONFIG CKPT --eval mIoU --quant-int8 \\
        --act-scales scales.json

The value of a module path is the running max of ``max|x|`` (or, with
``-p`` below 100, of that percentile of ``|x|``) over the images, keyed by
the JAX module path and written as the JAX tool writes it (``indent=1,
sort_keys=True``), so a table of either tool serves the other's CLI. The
model runs on the card unless ``--device cpu``; without a checkpoint its
weights are the seeded initializers (a smoke test only).
"""
import argparse
import json
import os.path as osp
import sys

sys.path.insert(0, osp.join(osp.dirname(osp.abspath(__file__)), '..'))


def parse_args(args=None):
    p = argparse.ArgumentParser(
        description='Record int8 activation scales from val images')
    p.add_argument('config')
    p.add_argument('checkpoint', nargs='?', default=None,
                   help='checkpoint (omit for seeded random weights: '
                        'only useful for smoke tests)')
    p.add_argument('-o', '--out', default='act_scales.json')
    p.add_argument('-n', '--num-images', type=int, default=8)
    p.add_argument('-p', '--percentile', type=float, default=100.0,
                   help='clip each image\'s statistic to this percentile '
                        'of |x| (outlier-robust; 100 = exact max)')
    p.add_argument('--device', default='cuda',
                   help='torch device (default: the card)')
    return p.parse_args(args)


def main(args=None):
    args = parse_args(args)
    import torch

    from pfst_tpu_torch.apis import init_segmentor
    from pfst_tpu_torch.apis.test import normalize_views
    from pfst_tpu_torch.datasets import build_dataset
    from pfst_tpu_torch.ops.quant import calibrate_act_scales
    from pfst_tpu_torch.utils import Config

    cfg = Config.fromfile(args.config)
    model = init_segmentor(cfg, args.checkpoint, device=args.device)
    device = next(model.parameters()).device
    dataset = build_dataset({**(cfg.data['val'] if 'val' in cfg.data
                                else cfg.data['test']), 'test_mode': True})
    batches = []
    for idx in range(min(args.num_images, len(dataset))):
        sample = dataset[idx]
        imgs, metas = sample['img'], sample['img_metas']
        if not isinstance(imgs, list):
            imgs, metas = [imgs], [metas]
        batches.append(normalize_views(imgs[:1], metas[:1], device)[0])
    with torch.inference_mode():
        scales = calibrate_act_scales(model.inference, batches,
                                      percentile=args.percentile)
    with open(args.out, 'w') as f:
        json.dump(scales, f, indent=1, sort_keys=True)
    print(f'{len(scales)} scales over {len(batches)} images -> {args.out}')
    return scales


if __name__ == '__main__':
    main()
