"""ISPRS Potsdam/Vaihingen dataset (port of ``pfst_tpu/datasets/isprs.py``;
mirrors ``rsiseg/datasets/isprs.py:7-25``)."""
from .builder import DATASETS
from .custom import CustomDataset


@DATASETS.register_module()
class ISPRSDataset(CustomDataset):
    """6-class ISPRS semantic labeling; index 0 in the png maps is the
    boundary/ignore, so ``reduce_zero_label=True``."""
    CLASSES = ('impervious_surface', 'building', 'low_vegetation', 'tree',
               'car', 'clutter')
    PALETTE = [[255, 255, 255], [0, 0, 255], [0, 255, 255], [0, 255, 0],
               [255, 255, 0], [255, 0, 0]]

    def __init__(self, **kwargs):
        kwargs.setdefault('img_suffix', '.png')
        kwargs.setdefault('seg_map_suffix', '.png')
        kwargs.setdefault('reduce_zero_label', True)
        super().__init__(**kwargs)
