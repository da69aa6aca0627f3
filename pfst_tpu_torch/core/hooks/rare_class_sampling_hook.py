"""Rare-class sampling statistics (port of
``pfst_tpu/core/hooks/rare_class_sampling_hook.py``; mirrors
``rsiseg/core/hook/rare_class_sampling_hook.py:31-60``).

``compute_class_stats`` walks a dataset's annotations and writes
``sample_class_stats.json`` (per image: class -> pixel count) and
``samples_with_class.json`` (class -> [[file, pixels]]) into a directory,
byte for byte as the JAX function does: they are the inputs of
``UDADataset``'s rare-class sampling. ``RareClassSamplingHook`` runs it
once before training on the loop's source dataset;
``tools/compute_class_stats_torch.py`` is its command line.
"""
from __future__ import annotations

import json
import os.path as osp

import numpy as np

from ...utils.logger import get_root_logger
from .hook import HOOKS, Hook


def compute_class_stats(dataset, out_dir: str):
    sample_class_stats = []
    samples_with_class = {}
    for idx in range(len(dataset)):
        gt = dataset.get_gt_seg_map_by_idx(idx)
        file = dataset.img_infos[idx]['ann']['seg_map']
        classes, counts = np.unique(gt, return_counts=True)
        entry = {'file': file}
        for c, n in zip(classes.tolist(), counts.tolist()):
            if c == dataset.ignore_index:
                continue
            entry[str(int(c))] = int(n)
            samples_with_class.setdefault(int(c), []).append(
                [file, int(n)])
        sample_class_stats.append(entry)
    with open(osp.join(out_dir, 'sample_class_stats.json'), 'w') as f:
        json.dump(sample_class_stats, f)
    with open(osp.join(out_dir, 'samples_with_class.json'), 'w') as f:
        json.dump(samples_with_class, f)
    get_root_logger().info(
        f'class stats for {len(sample_class_stats)} images -> {out_dir}')
    return sample_class_stats, samples_with_class


@HOOKS.register_module()
class RareClassSamplingHook(Hook):

    def __init__(self, out_dir=None, **kwargs):
        self.out_dir = out_dir

    def before_run(self, ctx):
        dataset = ctx.get('source_dataset')
        if dataset is None:
            return
        out_dir = self.out_dir or dataset.data_root
        compute_class_stats(dataset, out_dir)
