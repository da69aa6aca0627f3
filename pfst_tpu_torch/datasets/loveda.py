"""LoveDA dataset (port of ``pfst_tpu/datasets/loveda.py``; mirrors
``rsiseg/datasets/loveda.py``): 7 land-cover classes in PNG tiles, label
0 the no-data value (``reduce_zero_label``)."""
from .builder import DATASETS
from .custom import CustomDataset


@DATASETS.register_module()
class LoveDADataset(CustomDataset):
    CLASSES = ('background', 'building', 'road', 'water', 'barren',
               'forest', 'agricultural')
    PALETTE = [[255, 255, 255], [255, 0, 0], [255, 255, 0], [0, 0, 255],
               [159, 129, 183], [0, 255, 0], [255, 195, 128]]

    def __init__(self, **kwargs):
        kwargs.setdefault('img_suffix', '.png')
        kwargs.setdefault('seg_map_suffix', '.png')
        kwargs.setdefault('reduce_zero_label', True)
        super().__init__(**kwargs)
