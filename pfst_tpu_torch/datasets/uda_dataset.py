"""Source x target pairing dataset for UDA (port of
``pfst_tpu/datasets/uda_dataset.py``; mirrors
``rsiseg/datasets/uda_dataset.py:44-135``): ``__getitem__`` gives the
source sample plus ``target_img`` / ``target_img_strong_aug`` /
``target_img_metas``, and with a clean target snapshot
``target_img_ori`` and the target's replay metas; the length is ``len(source) * len(target)``, index
``idx`` pairing source ``idx // len(target)`` with target
``idx % len(target)``. Rare-class sampling waits for ROADMAP A12.
"""
from __future__ import annotations

from .builder import DATASETS


@DATASETS.register_module()
class UDADataset:

    def __init__(self, source, target, cfg):
        if cfg.get('rare_class_sampling') is not None:
            raise NotImplementedError('rare-class sampling is not ported '
                                      '(ROADMAP A12)')
        assert target.ignore_index == source.ignore_index
        assert tuple(target.CLASSES) == tuple(source.CLASSES)
        self.source = source
        self.target = target
        self.ignore_index = target.ignore_index
        self.CLASSES = target.CLASSES
        self.PALETTE = target.PALETTE

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
        s1 = self.source[idx // len(self.target)]
        s2 = self.target[idx % len(self.target)]
        return self._merge(s1, s2)

    def __len__(self):
        return len(self.source) * len(self.target)
