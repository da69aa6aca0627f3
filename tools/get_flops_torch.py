#!/usr/bin/env python
"""FLOPs and parameters of a config's segmentor (the PyTorch port's
counterpart of ``tools/get_flops.py``)::

    python tools/get_flops_torch.py <config> [--shape H [W]]

The FLOPs are ``torch.utils.flop_counter``'s count of one whole-image
forward (``encode_decode``, batch 1) at the shape; the JAX tool reads
XLA's cost analysis of its compiled forward, which counts other
operations too, so the two FLOP numbers differ (ROADMAP C2). The
parameters are the module's trainable tensors (the JAX tool's
``params`` collection; BN statistics are neither). Runs on the card
unless ``--device cpu``.
"""
import argparse
import os.path as osp
import sys

sys.path.insert(0, osp.join(osp.dirname(osp.abspath(__file__)), '..'))

from pfst_tpu_torch.utils import Config, DictAction  # noqa: E402


def parse_args(args=None):
    p = argparse.ArgumentParser(description='FLOPs and parameters')
    p.add_argument('config')
    p.add_argument('--shape', type=int, nargs='+', default=[2048, 1024])
    p.add_argument('--cfg-options', nargs='+', action=DictAction)
    p.add_argument('--device', default='cuda',
                   help='torch device (default: the card)')
    return p.parse_args(args)


def main(args=None):
    args = parse_args(args)
    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_dict(args.cfg_options)
    h, w = (args.shape * 2)[:2]

    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from pfst_tpu_torch.apis import init_segmentor
    model = init_segmentor(cfg, device=args.device)
    n_params = sum(p.numel() for p in model.parameters())
    img = torch.zeros((1, 3, h, w), device=next(model.parameters()).device)
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        model.encode_decode(img)
    flops = counter.get_total_flops()
    print('=' * 30)
    print(f'Input shape: (1, 3, {h}, {w})')
    print(f'Flops: {flops / 1e9:.2f} GFLOPs')
    print(f'Params: {n_params / 1e6:.2f} M')
    print('=' * 30)
    return flops, n_params


if __name__ == '__main__':
    main()
