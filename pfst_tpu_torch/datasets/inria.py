"""Inria aerial building dataset (port of ``pfst_tpu/datasets/inria.py``;
mirrors ``rsiseg/datasets/inria.py:13``)."""
from .builder import DATASETS
from .eo_dataset import EODataset


@DATASETS.register_module()
class InriaDataset(EODataset):
    CLASSES = ('background', 'building')
    PALETTE = [[0, 0, 0], [255, 255, 255]]
