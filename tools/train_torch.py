#!/usr/bin/env python
"""Training CLI of the PyTorch port (the counterpart of
``tools/train.py``; mirrors rsiseg's ``tools/train.py``)::

    python tools/train_torch.py <config> [--work-dir D] [--resume-from C]
        [--auto-resume] [--seed N] [--max-iters N] [--cfg-options k=v ...]
        [--launcher {none,pytorch,slurm}]

Runs on the card unless ``--device cpu``. Checkpoints are
``<work-dir>/iter_<N>.pth``. Data-parallel training runs one process a
GPU, each joining the process group of its launcher
(``pfst_tpu_torch.parallel.init_distributed``) with the backend of the
config's ``dist_params.backend`` (``'xla'``, the shipped default, is NCCL
on the card, gloo on the CPU)::

    torchrun --nproc_per_node 8 tools/train_torch.py <config> \
        --launcher pytorch          # or tools/dist_train_torch.sh <config> 8
    srun --ntasks 8 --gres gpu:8 python tools/train_torch.py <config> \
        --launcher slurm

``samples_per_gpu`` is each rank's batch. ``--tp N`` shards the
transformer blocks' attention heads and MLP units over N ranks and
``--zero [1|3]`` the AdamW moments (3: also the student, teacher and
frozen-reference weights) over the data ranks, as the JAX tool's flags do
(``cfg.parallel``); both run under a launcher. ``--sp N`` shards each
data index's training crop along its height over N ranks (an H x W grid
with ``--cfg-options parallel.spw=M``), the rest of the ranks data
indices; every rank holds the whole state and one block of every
activation, e.g. ``torchrun --nproc_per_node 2 tools/train_torch.py CONFIG
--launcher pytorch --sp 2``.
"""
import argparse
import os
import os.path as osp
import sys
import time

sys.path.insert(0, osp.join(osp.dirname(osp.abspath(__file__)), '..'))

from pfst_tpu_torch.utils import Config, DictAction, get_root_logger  # noqa


def parse_args(args=None):
    parser = argparse.ArgumentParser(description='Train a segmentor')
    parser.add_argument('config', help='train config file path')
    parser.add_argument('--work-dir', help='the dir to save logs/models')
    parser.add_argument('--load-from', help='checkpoint to load weights')
    parser.add_argument('--resume-from', help='checkpoint to resume')
    parser.add_argument('--auto-resume', action='store_true',
                        help='resume from the latest checkpoint')
    parser.add_argument('--no-validate', action='store_true',
                        help='skip evaluation during training')
    parser.add_argument('--seed', type=int, default=None,
                        help='random seed')
    parser.add_argument('--deterministic', action='store_true')
    parser.add_argument('--max-iters', type=int, default=None,
                        help='override runner.max_iters')
    parser.add_argument('--cfg-options', nargs='+', action=DictAction,
                        help='override config entries key=value')
    parser.add_argument('--device', default='cuda',
                        help='torch device (default: the card)')
    parser.add_argument('--launcher', default='none',
                        choices=['none', 'pytorch', 'slurm'],
                        help='join the process group of torchrun '
                             '(pytorch) or srun (slurm)')
    parser.add_argument('--local_rank', '--local-rank', type=int,
                        default=None, help='set by torch.distributed.'
                        'launch; read as LOCAL_RANK')
    parser.add_argument('--tp', type=int, default=None,
                        help='tensor-parallel degree: the transformer '
                        'blocks\' attention heads and MLP units shard over '
                        'this many ranks (the rest form the data axis); '
                        'equivalent to --cfg-options parallel.tp=N')
    parser.add_argument('--sp', type=int, default=None,
                        help='spatial-parallel degree: the training crop\'s '
                        'height shards over this many ranks (the rest form '
                        'the data axis), each holding one block of every '
                        'activation; equivalent to --cfg-options '
                        'parallel.sp=N')
    parser.add_argument('--zero', nargs='?', const=1, default=None,
                        type=int, choices=[1, 3],
                        help='ZeRO over the data ranks: --zero (or --zero '
                        '1) shards the AdamW moments; --zero 3 also the '
                        'student, teacher and frozen-reference weights; '
                        'equivalent to --cfg-options parallel.zero=N')
    return parser.parse_args(args)


def parallel_options(args) -> dict:
    """The ``--tp`` / ``--sp`` / ``--zero`` flags as ``cfg.parallel`` keys,
    merged over the config's own (``tools/train.py``)."""
    out = {}
    if args.tp:
        out['parallel.tp'] = args.tp
    if args.sp:
        out['parallel.sp'] = args.sp
    if args.zero:
        out['parallel.zero'] = args.zero
    return out


def main(args=None):
    args = parse_args(args)
    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_dict(args.cfg_options)
    if parallel_options(args):
        cfg.merge_from_dict(parallel_options(args))
    if args.local_rank is not None:
        os.environ.setdefault('LOCAL_RANK', str(args.local_rank))
    from pfst_tpu_torch.parallel import get_dist_info, init_distributed
    device = init_distributed(
        args.launcher, (cfg.get('dist_params') or {}).get('backend'),
        args.device) if args.launcher != 'none' else args.device
    rank, world = get_dist_info()
    work_dir = args.work_dir or cfg.get('work_dir') or osp.join(
        'work_dirs', osp.splitext(osp.basename(args.config))[0])
    timestamp = time.strftime('%Y%m%d_%H%M%S', time.localtime())
    if rank == 0:
        os.makedirs(work_dir, exist_ok=True)
        cfg.dump(osp.join(work_dir, osp.basename(args.config)))
    logger = get_root_logger(osp.join(work_dir, f'{timestamp}.log'))

    from pfst_tpu_torch.apis import set_random_seed, train_segmentor
    from pfst_tpu_torch.utils.collect_env import collect_env
    from pfst_tpu_torch.utils.set_env import setup_environment
    setup_environment(cfg)
    seed = args.seed if args.seed is not None else cfg.get('seed', 0)
    env_info = '\n'.join(f'{k}: {v}' for k, v in collect_env().items())
    logger.info('Environment info:\n' + '-' * 40 + f'\n{env_info}\n' +
                '-' * 40)
    logger.info(f'device {device} seed {seed} launcher {args.launcher} '
                f'world size {world}')
    logger.info(f'Config:\n{cfg.dump()}')
    if args.deterministic:
        set_random_seed(seed, deterministic=True)
    meta = dict(config=cfg.dump(), seed=seed,
                exp_name=osp.basename(args.config), time=timestamp)
    return train_segmentor(
        cfg,
        work_dir=work_dir,
        resume_from=args.resume_from,
        load_from=args.load_from,
        auto_resume=args.auto_resume,
        validate=not args.no_validate,
        seed=seed,
        meta=meta,
        max_iters_override=args.max_iters,
        device=device)


if __name__ == '__main__':
    import torch.distributed as dist
    try:
        main()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
