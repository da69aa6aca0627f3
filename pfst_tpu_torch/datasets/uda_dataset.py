"""Source x target pairing dataset for UDA (port of
``pfst_tpu/datasets/uda_dataset.py``; mirrors
``rsiseg/datasets/uda_dataset.py:44-135``): ``__getitem__`` gives the
source sample plus ``target_img`` / ``target_img_strong_aug`` /
``target_img_metas``, and with a clean target snapshot
``target_img_ori`` and the target's replay metas; the length is
``len(source) * len(target)``, index ``idx`` pairing source
``idx // len(target)`` with target ``idx % len(target)``.

With ``rare_class_sampling`` (``class_temp``, ``min_crop_ratio``,
``min_pixels``) every item is instead a rare-class draw
(``uda_dataset.py:17-114``): a class from a temperature softmax over the
source's class frequencies (``sample_class_stats.json``, written by
``compute_class_stats``), a source file holding more than ``min_pixels``
of it (``samples_with_class.json``), re-cropped up to ten times until the
crop holds enough of it, and a uniform target. The draws come from the
process-wide ``np.random``, in the JAX package's order, so one seed draws
the same class, file and target there and here.
"""
from __future__ import annotations

import json
import os.path as osp

import numpy as np

from ..utils.logger import get_root_logger, print_log
from .builder import DATASETS


def get_rcs_class_probs(data_root, temperature):
    """(``uda_dataset.py:17-40``): rarer classes get higher probability.
    Returns the classes, rarest first, and their probabilities."""
    with open(osp.join(data_root, 'sample_class_stats.json')) as f:
        sample_class_stats = json.load(f)
    overall = {}
    for s in sample_class_stats:
        s = dict(s)
        s.pop('file', None)
        for c, n in s.items():
            overall[int(c)] = overall.get(int(c), 0) + n
    overall = dict(sorted(overall.items(), key=lambda kv: kv[1]))
    freq = np.asarray(list(overall.values()), np.float64)
    freq = freq / freq.sum()
    freq = 1.0 - freq
    z = np.exp(freq / temperature)
    prob = z / z.sum()
    return list(overall.keys()), prob


@DATASETS.register_module()
class UDADataset:

    def __init__(self, source, target, cfg):
        assert target.ignore_index == source.ignore_index
        assert tuple(target.CLASSES) == tuple(source.CLASSES)
        self.source = source
        self.target = target
        self.ignore_index = target.ignore_index
        self.CLASSES = target.CLASSES
        self.PALETTE = target.PALETTE
        self.path2name = cfg.get('path2name', False)

        rcs_cfg = cfg.get('rare_class_sampling')
        self.rcs_enabled = rcs_cfg is not None
        if self.rcs_enabled:
            self.rcs_class_temp = rcs_cfg['class_temp']
            self.rcs_min_crop_ratio = rcs_cfg['min_crop_ratio']
            self.rcs_min_pixels = rcs_cfg['min_pixels']
            data_root = cfg['source'].get('rcs_root') or \
                cfg['source']['data_root']
            self.rcs_classes, self.rcs_classprob = get_rcs_class_probs(
                data_root, self.rcs_class_temp)
            print_log(f'RCS Classes: {self.rcs_classes}', get_root_logger())
            with open(osp.join(data_root, 'samples_with_class.json')) as f:
                swc = json.load(f)
            swc = {int(k): v for k, v in swc.items()
                   if int(k) in self.rcs_classes}
            self.samples_with_class = {}
            for c in self.rcs_classes:
                self.samples_with_class[c] = [
                    file.split('/')[-1] for file, pixels in swc[c]
                    if pixels > self.rcs_min_pixels]
                assert len(self.samples_with_class[c]) > 0
            self.file_to_idx = {}
            for i, dic in enumerate(self.source.img_infos):
                file = dic['ann']['seg_map']
                if self.path2name:
                    file = file.split('/')[-1]
                self.file_to_idx[file] = i

    def draw_rcs_class(self):
        """A class of the temperature softmax (the first draw of
        ``get_rare_class_sample``)."""
        return np.random.choice(self.rcs_classes, p=self.rcs_classprob)

    def get_rare_class_sample(self):
        """(``uda_dataset.py:92-114``) a class-balanced source draw with
        the min-pixel re-crop loop, and a uniform target."""
        c = self.draw_rcs_class()
        f1 = np.random.choice(self.samples_with_class[c])
        i1 = self.file_to_idx[f1]
        s1 = self.source[i1]
        if self.rcs_min_crop_ratio > 0:
            for _ in range(10):
                n_class = int(np.sum(s1['gt_semantic_seg'] == c))
                if n_class > self.rcs_min_pixels * self.rcs_min_crop_ratio:
                    break
                s1 = self.source[i1]  # re-crop via the pipeline
        i2 = int(np.random.choice(len(self.target)))
        s2 = self.target[i2]
        return self._merge(s1, s2)

    @staticmethod
    def _merge(s1, s2):
        results = {**s1, 'target_img_metas': s2['img_metas'],
                   'target_img': s2['img']}
        if 'img_strong_aug' in s2:
            results['target_img_strong_aug'] = s2['img_strong_aug']
        if 'ori_img' in s2:
            # PFSTV4's clean view and the target's own replay metas, which
            # a source sample's metas of the same names must not clobber
            # (``uda_dataset.py:103-117``)
            results['target_img_ori'] = s2['ori_img']
            for k in ('rotate_k', 'flip_vertical', 'flip_horizontal'):
                if k in s2:
                    results[k] = s2[k]
        return results

    def __getitem__(self, idx):
        if self.rcs_enabled:
            return self.get_rare_class_sample()
        s1 = self.source[idx // len(self.target)]
        s2 = self.target[idx % len(self.target)]
        return self._merge(s1, s2)

    def __len__(self):
        return len(self.source) * len(self.target)
