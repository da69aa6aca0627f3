"""Dataset wrappers (port of ``pfst_tpu/datasets/dataset_wrappers.py``;
mirrors ``rsiseg/datasets/dataset_wrappers.py``).

``MultiImageMixDataset`` is not ported (ROADMAP A12): ``build_dataset``
raises for it.
"""
from __future__ import annotations

import bisect
from itertools import accumulate

import numpy as np

from .builder import DATASETS


@DATASETS.register_module()
class ConcatDataset:
    """Datasets one after the other (``dataset_wrappers.py:12-60``); with
    ``separate_eval`` each is evaluated on its own part of the results,
    its metrics prefixed by its index."""

    def __init__(self, datasets, separate_eval=True):
        self.datasets = list(datasets)
        self.separate_eval = separate_eval
        self.CLASSES = self.datasets[0].CLASSES
        self.PALETTE = getattr(self.datasets[0], 'PALETTE', None)
        self.ignore_index = getattr(self.datasets[0], 'ignore_index', 255)
        self.cumulative_sizes = list(accumulate(len(d)
                                                for d in self.datasets))

    def __len__(self):
        return self.cumulative_sizes[-1]

    def _locate(self, idx):
        di = bisect.bisect_right(self.cumulative_sizes, idx)
        return di, idx if di == 0 else idx - self.cumulative_sizes[di - 1]

    def __getitem__(self, idx):
        di, si = self._locate(idx)
        return self.datasets[di][si]

    def get_gt_seg_map_by_idx(self, idx):
        di, si = self._locate(idx)
        return self.datasets[di].get_gt_seg_map_by_idx(si)

    def pre_eval(self, preds, indices):
        if not isinstance(indices, list):
            indices = [indices]
        if not isinstance(preds, list):
            preds = [preds]
        out = []
        for pred, idx in zip(preds, indices):
            di, si = self._locate(idx)
            out.extend(self.datasets[di].pre_eval(pred, si))
        return out

    def evaluate(self, results, **kwargs):
        if not self.separate_eval:
            return self.datasets[0].evaluate(results, **kwargs)
        start, out = 0, {}
        for i, ds in enumerate(self.datasets):
            res = ds.evaluate(results[start:start + len(ds)], **kwargs)
            start += len(ds)
            out.update({f'{i}_{k}': v for k, v in res.items()})
        return out


@DATASETS.register_module()
class RepeatDataset:
    """``dataset`` ``times`` over (``dataset_wrappers.py:63-78``)."""

    def __init__(self, dataset, times):
        self.dataset = dataset
        self.times = times
        self.CLASSES = dataset.CLASSES
        self.PALETTE = getattr(dataset, 'PALETTE', None)
        self.ignore_index = getattr(dataset, 'ignore_index', 255)
        self._ori_len = len(dataset)

    def __getitem__(self, idx):
        return self.dataset[idx % self._ori_len]

    def __len__(self):
        return self.times * self._ori_len


@DATASETS.register_module()
class MultiDomainDataset:
    """One sample of each domain an item, keys prefixed ``dom{i+1}_``
    (``dataset_wrappers.py:81-103``): domain 1 by the index, the others
    drawn uniformly from ``np.random``. The input of the domain-adaptor
    family."""

    def __init__(self, datasets, cfg=None):
        self.datasets = list(datasets)
        self.CLASSES = self.datasets[0].CLASSES
        self.PALETTE = getattr(self.datasets[0], 'PALETTE', None)
        self.ignore_index = getattr(self.datasets[0], 'ignore_index', 255)

    def __len__(self):
        return len(self.datasets[0])

    def __getitem__(self, idx):
        results = {}
        for i, ds in enumerate(self.datasets):
            cur = idx if i == 0 else int(np.random.randint(len(ds)))
            for key, value in ds[cur].items():
                results[f'dom{i + 1}_{key}'] = value
        return results
