from .builder import (DATASETS, PIPELINES, DataLoader, build_dataloader,
                      build_dataset, collate)
from .custom import CustomDataset
from .dataset_wrappers import (ConcatDataset, MultiDomainDataset,
                               RepeatDataset)
from .eo_dataset import EO_FEEDERS, EODataset
from .inria import InriaDataset
from .isprs import ISPRSDataset
from .season_net import SeasonNetDataset
from .uda_dataset import UDADataset
from .uda_dataset_v2 import UDADatasetV2
from . import pipelines  # noqa: F401

__all__ = [
    'DATASETS', 'PIPELINES', 'DataLoader', 'build_dataset',
    'build_dataloader', 'collate', 'CustomDataset', 'ConcatDataset',
    'MultiDomainDataset', 'RepeatDataset', 'EODataset',
    'EO_FEEDERS', 'InriaDataset', 'ISPRSDataset', 'SeasonNetDataset',
    'UDADataset', 'UDADatasetV2'
]
