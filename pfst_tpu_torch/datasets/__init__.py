from .builder import (DATASETS, PIPELINES, DataLoader, build_dataloader,
                      build_dataset, collate)
from .custom import CustomDataset
from .isprs import ISPRSDataset
from .uda_dataset import UDADataset
from . import pipelines  # noqa: F401

__all__ = [
    'DATASETS', 'PIPELINES', 'DataLoader', 'build_dataset',
    'build_dataloader', 'collate', 'CustomDataset', 'ISPRSDataset',
    'UDADataset'
]
