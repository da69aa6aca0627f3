#!/usr/bin/env python
"""Data-loader headroom of the PyTorch port (host side only; the
counterpart of ``tools/bench_loader.py``)::

    python tools/bench_loader_torch.py [--batches 30] [--step-s S]

Times the Pots->Vaih leaf config's UDA train loader (the whole
per-sample pipeline: load, resize jitter, crop, rot90, flips,
photometric distortion, normalize, pad, strong augmentation) in batches
per second, with thread and process workers at several batch sizes, and
reports the ratio of its seconds per batch to ``--step-s``, a device
step time measured elsewhere (``chip_smoke.py`` prints the card's). Needs
``data/Potsdam_IRRG_1024`` and ``data/Vaihingen_IRRG_1024``
(``tools/make_synthetic_data_torch.py`` writes synthetic ones).
"""
import argparse
import json
import os
import os.path as osp
import sys
import time

sys.path.insert(0, osp.join(osp.dirname(osp.abspath(__file__)), '..'))

from pfst_tpu_torch.utils import Config  # noqa: E402

LEAF = osp.join(osp.dirname(osp.abspath(__file__)), '..', 'configs', 'pfst',
                'pfst_pots_irrg2vaih_irrg_deeplabv3plus_r50-d8.py')


def bench(cfg, batch, workers, use_processes, n_batches):
    """Seconds per batch of ``n_batches`` after a first, warming one."""
    from pfst_tpu_torch.datasets import build_dataloader, build_dataset
    ds = build_dataset(cfg.data['train'])
    loader = build_dataloader(ds, batch, workers, shuffle=True,
                              use_processes=use_processes, seed=0,
                              infinite=True)
    it = iter(loader)
    try:
        next(it)
        t0 = time.perf_counter()
        for _ in range(n_batches):
            next(it)
        return (time.perf_counter() - t0) / n_batches
    finally:
        it.close()
        loader.close()


def main(args=None):
    p = argparse.ArgumentParser(description='Data-loader throughput')
    p.add_argument('--batches', type=int, default=30)
    p.add_argument('--batch-sizes', type=int, nargs='*', default=[2, 8, 16])
    p.add_argument('--workers', type=int, default=4)
    p.add_argument('--step-s', type=float, required=True,
                   help='a measured device s/iter to set the loader against')
    a = p.parse_args(args)
    cfg = Config.fromfile(LEAF)

    print(f'# host cpu count: {os.cpu_count()}')
    records = []
    for batch in a.batch_sizes:
        for procs in (False, True):
            s = bench(cfg, batch, a.workers, procs, a.batches)
            rec = {'metric': 'uda loader batches/sec', 'batch': batch,
                   'workers': a.workers,
                   'mode': 'process' if procs else 'thread',
                   's_per_batch': s, 'samples_per_sec': batch / s,
                   'data_over_step_ratio': s / a.step_s}
            print(json.dumps(rec))
            records.append(rec)
    return records


if __name__ == '__main__':
    main()
