#!/usr/bin/env python
"""Evaluation CLI of the PyTorch port (the counterpart of
``tools/test.py``; mirrors rsiseg's ``tools/test.py``)::

    python tools/test_torch.py <config> <checkpoint> --eval mIoU

Runs on the card unless ``--device cpu``. UDA checkpoints are detected by
their keys and the student is evaluated (rsiseg ``tools/test.py:237-
242``; ``--revise_checkpoint_key`` is accepted as a no-op).
``--format-only`` writes each tile's label map as an 8-bit PNG named
after the tile under ``--imgfile-prefix``::

    python tools/test_torch.py <config> <checkpoint> --format-only \
        --imgfile-prefix work_dirs/format

``--show-dir`` is accepted and writes nothing, as in the JAX CLI.
``--quant-int8`` scores the int8 program (``pfst_tpu_torch/ops/quant.py``),
with ``--act-scales`` a JSON table of ``tools/calibrate_int8_torch.py`` or
``tools/calibrate_int8.py`` (dynamic scales without one)::

    python tools/test_torch.py <config> <checkpoint> --eval mIoU \
        --quant-int8 --act-scales scales.json

With ``--launcher pytorch`` (torchrun, or ``tools/dist_test_torch.sh``)
or ``slurm`` each rank scores its share of the images through
``multi_gpu_test`` and rank 0 reports::

    torchrun --nproc_per_node 8 tools/test_torch.py <config> <checkpoint> \
        --eval mIoU --launcher pytorch

``--spatial N`` under a launcher of N ranks shards each whole-image
forward's height over them instead (every rank reads every image, rank 0
scores), for scenes too large for one card::

    torchrun --nproc_per_node 2 tools/test_torch.py <config> <checkpoint> \
        --eval mIoU --launcher pytorch --spatial 2
"""
import argparse
import json
import os
import os.path as osp
import sys

sys.path.insert(0, osp.join(osp.dirname(osp.abspath(__file__)), '..'))

from pfst_tpu_torch.utils import Config, DictAction, get_root_logger  # noqa


def parse_args(args=None):
    parser = argparse.ArgumentParser(description='Test a segmentor')
    parser.add_argument('config')
    parser.add_argument('checkpoint')
    parser.add_argument('--eval', nargs='+',
                        help='metrics: mIoU/mDice/mFscore')
    parser.add_argument('--out', help='json file to dump results')
    parser.add_argument('--format-only', action='store_true')
    parser.add_argument('--imgfile-prefix', default='work_dirs/format',
                        help='output dir for --format-only pngs')
    parser.add_argument('--aug-test', action='store_true',
                        help='multi-scale + flip TTA')
    parser.add_argument('--show-dir',
                        help='accepted for compatibility; writes nothing '
                             '(the JAX CLI draws no overlays either)')
    parser.add_argument('--opacity', type=float, default=0.5)
    parser.add_argument('--revise_checkpoint_key', type=bool,
                        default=False, help='compat no-op')
    parser.add_argument('--cfg-options', nargs='+', action=DictAction)
    parser.add_argument('--eval-options', nargs='+', action=DictAction)
    parser.add_argument('--quant-int8', action='store_true',
                        help='int8 convolutions and Dense layers; see '
                             'pfst_tpu_torch/ops/quant.py')
    parser.add_argument('--act-scales', default=None,
                        help='static activation-scale JSON from '
                             'tools/calibrate_int8_torch.py (default: '
                             'dynamic scales)')
    parser.add_argument('--device-normalize', nargs='?', const='uint8',
                        default=None, choices=['uint8', 'float16'],
                        help='send eval images to the card on the 0-255 '
                             'scale and normalize them there')
    parser.add_argument('--device', default='cuda',
                        help='torch device (default: the card)')
    parser.add_argument('--spatial', type=int, default=0,
                        help='shard each whole-image forward\'s height '
                        'over this many ranks (--launcher; the halo '
                        'exchange of parallel/spatial.py), for scenes too '
                        'large for one card; heights that do not divide '
                        'are edge-padded')
    parser.add_argument('--launcher', default='none',
                        choices=['none', 'pytorch', 'slurm'],
                        help='join the process group of torchrun '
                             '(pytorch) or srun (slurm)')
    parser.add_argument('--local_rank', '--local-rank', type=int,
                        default=None, help='set by torch.distributed.'
                        'launch; read as LOCAL_RANK')
    return parser.parse_args(args)


def main(args=None):
    args = parse_args(args)
    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_dict(args.cfg_options)
    if args.local_rank is not None:
        os.environ.setdefault('LOCAL_RANK', str(args.local_rank))
    from pfst_tpu_torch.parallel import get_dist_info, init_distributed
    device = init_distributed(
        args.launcher, (cfg.get('dist_params') or {}).get('backend'),
        args.device) if args.launcher != 'none' else args.device
    rank, world = get_dist_info()
    logger = get_root_logger()
    if args.aug_test:
        tta = cfg.data['test']['pipeline'][1]
        tta['img_ratios'] = [0.5, 0.75, 1.0, 1.25, 1.5, 1.75]
        tta['flip'] = True
    from pfst_tpu_torch.apis import (init_segmentor, multi_gpu_test,
                                     single_gpu_test)
    from pfst_tpu_torch.datasets import build_dataloader, build_dataset
    from pfst_tpu_torch.datasets.pipelines import DeferNormalize
    if args.device_normalize and DeferNormalize.swap_into(
            cfg.data['test']['pipeline'], args.device_normalize) is None:
        print('warning: --device-normalize: no Normalize in the test '
              'pipeline; running unchanged', file=sys.stderr)

    dataset = build_dataset({**cfg.data['test'], 'test_mode': True})
    loader = build_dataloader(dataset, 1, cfg.data.get('workers_per_gpu', 2),
                              shuffle=False)
    model = init_segmentor(cfg, args.checkpoint, device=device)
    extra = {}
    if args.quant_int8:
        extra['quant_int8'] = True
        if args.act_scales:
            with open(args.act_scales) as f:
                extra['act_scales'] = json.load(f)
    test_fn = multi_gpu_test if world > 1 else single_gpu_test
    if args.spatial:
        # spatial shards ONE forward over the ranks (memory-bound scenes);
        # image-sharded multi_gpu_test is the throughput layout: they do
        # not compose, and spatial wins when asked for (tools/test.py)
        test_fn = single_gpu_test
        extra['spatial'] = args.spatial
    results = test_fn(
        model, loader, pre_eval=bool(args.eval) and not args.format_only,
        format_only=args.format_only, out_dir=args.show_dir, **extra)
    if rank > 0:
        return results
    if args.format_only:
        files = dataset.format_results(results, args.imgfile_prefix)
        logger.info(f'{len(files)} result maps written to '
                    f'{args.imgfile_prefix}')
    if args.eval:
        res = dataset.evaluate(results, metric=args.eval, logger=logger,
                               **dict(args.eval_options or {}))
        if args.out:
            with open(args.out, 'w') as f:
                json.dump({k: float(v) for k, v in res.items()}, f,
                          indent=2)
        return res
    return results


if __name__ == '__main__':
    import torch.distributed as dist
    try:
        main()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
