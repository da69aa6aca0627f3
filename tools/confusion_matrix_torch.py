#!/usr/bin/env python
"""Confusion matrix of a checkpoint on the test set (the PyTorch port's
counterpart of ``tools/confusion_matrix.py``)::

    python tools/confusion_matrix_torch.py <config> <checkpoint> [save_dir]

Rows are the ground-truth classes, columns the predicted ones; the table
printed is each row in percent of its pixels. With ``save_dir`` the
counts go to ``confusion.npy`` and, where matplotlib is installed, a plot
to ``confusion_matrix.png``. Runs on the card unless ``--device cpu``.
"""
import argparse
import os
import os.path as osp
import sys

sys.path.insert(0, osp.join(osp.dirname(osp.abspath(__file__)), '..'))

import numpy as np  # noqa: E402

from pfst_tpu_torch.utils import Config, DictAction  # noqa: E402


def parse_args(args=None):
    p = argparse.ArgumentParser(description='Confusion matrix')
    p.add_argument('config')
    p.add_argument('checkpoint')
    p.add_argument('save_dir', nargs='?', default=None)
    p.add_argument('--show', action='store_true')
    p.add_argument('--color-theme', default='winter')
    p.add_argument('--cfg-options', nargs='+', action=DictAction)
    p.add_argument('--device', default='cuda',
                   help='torch device (default: the card)')
    return p.parse_args(args)


def calculate_confusion_matrix(dataset, results):
    """(n, n) float64 counts: row the label, column the prediction, over
    the pixels whose label is not the ignore index."""
    n = len(dataset.CLASSES)
    confusion = np.zeros((n, n), dtype=np.float64)
    for idx, pred in enumerate(results):
        gt = dataset.get_gt_seg_map_by_idx(idx)
        valid = gt != dataset.ignore_index
        inds = n * gt[valid].astype(np.int64) + pred[valid].astype(np.int64)
        confusion += np.bincount(inds, minlength=n**2).reshape(n, n)
    return confusion


def _plot(norm, classes, theme, path):
    try:
        import matplotlib
    except ImportError as e:
        print(f'plot skipped: {e}')
        return
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(8, 8))
    im = ax.imshow(norm, cmap=theme)
    ax.set_xticks(range(len(classes)))
    ax.set_yticks(range(len(classes)))
    ax.set_xticklabels(classes, rotation=45, ha='right')
    ax.set_yticklabels(classes)
    fig.colorbar(im)
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)


def main(args=None):
    args = parse_args(args)
    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_dict(args.cfg_options)

    from pfst_tpu_torch.apis import init_segmentor, single_gpu_test
    from pfst_tpu_torch.datasets import build_dataloader, build_dataset

    dataset = build_dataset({**cfg.data['test'], 'test_mode': True})
    loader = build_dataloader(dataset, 1, 2, shuffle=False)
    model = init_segmentor(cfg, args.checkpoint, device=args.device)
    results = single_gpu_test(model, loader, pre_eval=False)

    confusion = calculate_confusion_matrix(dataset, results)
    row_sum = confusion.sum(axis=1, keepdims=True)
    norm = confusion / np.maximum(row_sum, 1) * 100
    print('Confusion matrix (% of gt row):')
    print(' ' * 20 + ' '.join(f'{c[:8]:>9}' for c in dataset.CLASSES))
    for name, row in zip(dataset.CLASSES, norm):
        print(f'{name[:18]:>18}: ' + ' '.join(f'{v:9.2f}' for v in row))
    if args.save_dir:
        os.makedirs(args.save_dir, exist_ok=True)
        np.save(osp.join(args.save_dir, 'confusion.npy'), confusion)
        _plot(norm, dataset.CLASSES, args.color_theme,
              osp.join(args.save_dir, 'confusion_matrix.png'))
    return confusion


if __name__ == '__main__':
    main()
