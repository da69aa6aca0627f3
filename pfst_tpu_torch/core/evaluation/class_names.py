"""Dataset class-name / palette lookup by alias (port of
``pfst_tpu/core/evaluation/class_names.py``; mirrors
``rsiseg/core/evaluation/class_names.py``). The tables come from the
registered dataset classes: ISPRS, Inria, LoveDA and SeasonNet.
SeasonNet's class has no PALETTE (its dataset takes the feeder's).
"""
from __future__ import annotations

CITYSCAPES_CLASSES = (
    'road', 'sidewalk', 'building', 'wall', 'fence', 'pole',
    'traffic light', 'traffic sign', 'vegetation', 'terrain', 'sky',
    'person', 'rider', 'car', 'truck', 'bus', 'train', 'motorcycle',
    'bicycle')
CITYSCAPES_PALETTE = [
    [128, 64, 128], [244, 35, 232], [70, 70, 70], [102, 102, 156],
    [190, 153, 153], [153, 153, 153], [250, 170, 30], [220, 220, 0],
    [107, 142, 35], [152, 251, 152], [70, 130, 180], [220, 20, 60],
    [255, 0, 0], [0, 0, 142], [0, 0, 70], [0, 60, 100], [0, 80, 100],
    [0, 0, 230], [119, 11, 32]]


def _dataset_tables():
    from ...datasets import (InriaDataset, ISPRSDataset, LoveDADataset,
                             SeasonNetDataset)
    return {'isprs': ISPRSDataset, 'potsdam': ISPRSDataset,
            'vaihingen': ISPRSDataset, 'inria': InriaDataset,
            'loveda': LoveDADataset, 'season_net': SeasonNetDataset,
            'seasonnet': SeasonNetDataset}


def _lookup(dataset: str):
    alias = dataset.lower()
    tables = _dataset_tables()
    if alias not in tables:
        raise ValueError(f'Unrecognized dataset: {dataset} '
                         f'(known: cityscapes, {", ".join(tables)})')
    return tables[alias]


def get_classes(dataset: str):
    """Class-name tuple for a dataset alias."""
    if dataset.lower() == 'cityscapes':
        return CITYSCAPES_CLASSES
    return _lookup(dataset).CLASSES


def get_palette(dataset: str):
    """RGB palette (list of [r, g, b]) for a dataset alias."""
    if dataset.lower() == 'cityscapes':
        return CITYSCAPES_PALETTE
    return _lookup(dataset).PALETTE
