"""UDADatasetV2 (port of ``pfst_tpu/datasets/uda_dataset_v2.py``; mirrors
``rsiseg/datasets/uda_dataset_v2.py``), used by the SeasonNet spring ->
fall config: the length is the source's, and each item pairs source
``idx`` with a target drawn uniformly from the process-wide ``np.random``
after the source sample's own draws (``uda_dataset_v2.py:120-140``).
"""
from __future__ import annotations

import numpy as np

from .builder import DATASETS
from .uda_dataset import UDADataset


@DATASETS.register_module()
class UDADatasetV2(UDADataset):

    def __getitem__(self, idx):
        s1 = self.source[idx]
        s2 = self.target[int(np.random.randint(len(self.target)))]
        return self._merge(s1, s2)

    def __len__(self):
        return len(self.source)
