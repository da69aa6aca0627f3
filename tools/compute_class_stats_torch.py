#!/usr/bin/env python
"""Rare-class-sampling statistics with the PyTorch port (the counterpart of
``tools/compute_class_stats.py``, with the same arguments)::

    python tools/compute_class_stats_torch.py <config> [--split train]
        [--branch source|target|flat] [-o OUT_DIR]

Writes ``sample_class_stats.json`` and ``samples_with_class.json`` of the
split's dataset (its ``source`` or ``target`` branch for a UDA pair) into
``OUT_DIR``, by default the dataset's ``data_root``: the inputs of
``UDADataset``'s ``rare_class_sampling``.
"""
import argparse
import os.path as osp
import sys

sys.path.insert(0, osp.join(osp.dirname(osp.abspath(__file__)), '..'))

from pfst_tpu_torch.utils import Config, DictAction  # noqa: E402


def main(args=None):
    p = argparse.ArgumentParser()
    p.add_argument('config')
    p.add_argument('--split', default='train')
    p.add_argument('--branch', default='source',
                   choices=['source', 'target', 'flat'])
    p.add_argument('-o', '--out-dir', default=None)
    p.add_argument('--cfg-options', nargs='+', action=DictAction)
    a = p.parse_args(args)
    cfg = Config.fromfile(a.config)
    if a.cfg_options:
        cfg.merge_from_dict(a.cfg_options)

    from pfst_tpu_torch.core.hooks import compute_class_stats
    from pfst_tpu_torch.datasets import build_dataset

    node = cfg.data[a.split]
    if a.branch in node:
        node = node[a.branch]
    ds = build_dataset(node)
    out_dir = a.out_dir or ds.data_root or '.'
    return compute_class_stats(ds, out_dir)


if __name__ == '__main__':
    main()
