from .builder import (DATASETS, PIPELINES, DataLoader, build_dataloader,
                      build_dataset, collate)
from .custom import CustomDataset
from .dataset_wrappers import (ConcatDataset, MultiDomainDataset,
                               MultiImageMixDataset, RepeatDataset)
from .eo_dataset import EO_FEEDERS, EODataset
from .inria import InriaDataset
from .isprs import ISPRSDataset
from .loveda import LoveDADataset
from .season_net import SeasonNetDataset
from .uda_dataset import UDADataset
from .uda_dataset_v2 import UDADatasetV2
from . import pipelines  # noqa: F401

__all__ = [
    'DATASETS', 'PIPELINES', 'DataLoader', 'build_dataset',
    'build_dataloader', 'collate', 'CustomDataset', 'ConcatDataset',
    'MultiDomainDataset', 'MultiImageMixDataset', 'RepeatDataset',
    'EODataset', 'EO_FEEDERS', 'InriaDataset', 'ISPRSDataset',
    'LoveDADataset', 'SeasonNetDataset',
    'UDADataset', 'UDADatasetV2'
]
