"""SeasonNet dataset (port of ``pfst_tpu/datasets/season_net.py``;
mirrors ``rsiseg/datasets/season_net.py:7``)."""
from .builder import DATASETS
from .eo_dataset import SEASON_NET_CLASSES, EODataset


@DATASETS.register_module()
class SeasonNetDataset(EODataset):
    CLASSES = SEASON_NET_CLASSES
