#!/usr/bin/env python
"""Write the train pipeline's first samples as PNGs for inspection (the
PyTorch port's counterpart of ``tools/browse_dataset.py``)::

    python tools/browse_dataset_torch.py <config> [--output-dir D] [--num N]

Each ``sample_<i>.png`` is the image stretched to 0-255 beside it
blended with its palette-coloured labels (``--opacity``). The dataset
must yield an (H, W, 3) ``img`` and an (H, W) ``gt_semantic_seg``
before formatting (a source dataset, or a pipeline without
``DefaultFormatBundle``).
"""
import argparse
import os
import os.path as osp
import sys

sys.path.insert(0, osp.join(osp.dirname(osp.abspath(__file__)), '..'))

import numpy as np  # noqa: E402

from pfst_tpu_torch.utils import Config, DictAction  # noqa: E402


def render(img, gt, palette, opacity):
    """The image stretched to uint8 beside its blend with the coloured
    labels, (H, 2W, 3)."""
    img = np.asarray(img)
    lo, hi = img.min(), img.max()
    img8 = ((img - lo) / max(hi - lo, 1e-6) * 255).astype(np.uint8)
    color = np.zeros_like(img8)
    valid = gt < len(palette)
    color[valid] = palette[gt[valid]]
    overlay = (img8 * (1 - opacity) + color * opacity).astype(np.uint8)
    return np.concatenate([img8, overlay], axis=1)


def main(args=None):
    p = argparse.ArgumentParser(description='Browse a dataset')
    p.add_argument('config')
    p.add_argument('--output-dir', default='work_dirs/browse')
    p.add_argument('--num', type=int, default=8)
    p.add_argument('--opacity', type=float, default=0.5)
    p.add_argument('--cfg-options', nargs='+', action=DictAction)
    a = p.parse_args(args)
    cfg = Config.fromfile(a.config)
    if a.cfg_options:
        cfg.merge_from_dict(a.cfg_options)

    from pfst_tpu_torch.datasets import build_dataset
    from pfst_tpu_torch.datasets.pipelines.png import write_png
    ds = build_dataset(cfg.data['train'])
    palette = np.array(ds.PALETTE or [[0, 0, 0]], np.uint8)
    os.makedirs(a.output_dir, exist_ok=True)
    n = min(a.num, len(ds))
    paths = []
    for i in range(n):
        s = ds[i]
        paths.append(osp.join(a.output_dir, f'sample_{i}.png'))
        write_png(paths[-1], render(s['img'], s['gt_semantic_seg'], palette,
                                    a.opacity))
    print(f'wrote {n} samples to {a.output_dir}')
    return paths


if __name__ == '__main__':
    main()
