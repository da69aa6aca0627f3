"""EODataset: a dataset fed by an on-disk layout scanner (port of
``pfst_tpu/datasets/eo_dataset.py``; the reference's ``EODataset``,
``rsiseg/datasets/custom.py:22-375``, reads Dataset4EO datapipes).

A *feeder* scans a concrete layout and returns ``img_infos`` records with
absolute paths, and the CLASSES and PALETTE. Built in, as in the JAX file:

* ``inria_clipped``: pre-clipped Inria aerial building tiles,
  ``[Inria_clipped/]{split}/{images,gt}``, filtered by city prefix
  (``datapipe_cfg=dict(city_names=[...])``);
* ``season_net``: SeasonNet RGB uint16 TIFF tiles,
  ``{split}/{images,labels}``, filtered by season in the name
  (``datapipe_cfg=dict(seasons=[...])``).

Others register with ``@EO_FEEDERS.register_module()``.
"""
from __future__ import annotations

import os.path as osp
from typing import List, Optional

import numpy as np

from ..utils.registry import Registry
from .builder import DATASETS
from .custom import CustomDataset, scandir
from .pipelines.loading import imread

EO_FEEDERS = Registry('eo_feeders')

_IMG_EXTS = ('.png', '.jpg', '.jpeg', '.tif', '.tiff')


def _scan_pairs(img_root: str, ann_root: Optional[str],
                name_filter=None) -> List[dict]:
    """One record per image under ``img_root`` (sorted, recursive), with
    the label of the same stem under ``ann_root`` where one exists."""
    infos = []
    for name in scandir(img_root, recursive=True):
        if not name.lower().endswith(_IMG_EXTS):
            continue
        if name_filter is not None and not name_filter(name):
            continue
        info = dict(filename=osp.join(img_root, name))
        if ann_root is not None:
            stem = osp.splitext(name)[0]
            for ext in _IMG_EXTS:
                cand = osp.join(ann_root, stem + ext)
                if osp.exists(cand):
                    info['ann'] = dict(seg_map=cand)
                    break
        infos.append(info)
    return infos


@EO_FEEDERS.register_module(name='inria_clipped')
def inria_clipped(root, split='train', city_names=None, **kw):
    base = osp.join(root, 'Inria_clipped') if \
        osp.exists(osp.join(root, 'Inria_clipped')) else root
    img_root = osp.join(base, split, 'images')
    ann_root = osp.join(base, split, 'gt')
    if not osp.exists(ann_root):
        ann_root = None
    flt = None
    if city_names:
        def flt(n):
            return any(osp.basename(n).startswith(c) for c in city_names)
    infos = _scan_pairs(img_root, ann_root, flt)
    return infos, ('background', 'building'), [[0, 0, 0], [255, 255, 255]]


SEASON_NET_CLASSES = tuple(f'class_{i}' for i in range(33))


@EO_FEEDERS.register_module(name='season_net')
def season_net(root, split='train', seasons=None, **kw):
    img_root = osp.join(root, split, 'images')
    ann_root = osp.join(root, split, 'labels')
    if not osp.exists(ann_root):
        ann_root = None
    flt = None
    if seasons:
        def flt(n):
            return any(s in n for s in seasons)
    infos = _scan_pairs(img_root, ann_root, flt)
    palette = np.random.RandomState(7).randint(0, 255, size=(33, 3)).tolist()
    return infos, SEASON_NET_CLASSES, palette


@DATASETS.register_module()
class EODataset(CustomDataset):
    """A ``CustomDataset`` whose records come from the feeder
    ``datapipe`` (with ``datapipe_cfg``) over ``data_root`` and ``split``;
    paths are absolute, so the pipeline's prefixes are None."""

    def __init__(self, pipeline, datapipe, data_root=None, split='train',
                 datapipe_cfg=None, classes=None, palette=None, **kwargs):
        self.datapipe = datapipe
        self.datapipe_cfg = dict(datapipe_cfg or {})
        self._split_name = split
        feeder = EO_FEEDERS.get(datapipe)
        if feeder is None:
            raise KeyError(f'unknown EO feeder {datapipe}; register it '
                           f'in pfst_tpu_torch/datasets/eo_dataset.py')
        infos, feed_classes, feed_palette = feeder(
            data_root, split=split, **self.datapipe_cfg)
        self._feeder_infos = infos
        kwargs.setdefault('img_suffix', '.png')
        kwargs.setdefault('seg_map_suffix', '.png')
        super().__init__(pipeline, img_dir='', ann_dir='', data_root=None,
                         split=None, classes=classes, palette=palette,
                         **kwargs)
        if self.CLASSES is None:
            self.CLASSES = feed_classes
        if self.PALETTE is None:
            self.PALETTE = feed_palette

    def load_annotations(self, *args, **kwargs):
        return self._feeder_infos

    def pre_pipeline(self, results):
        results['seg_fields'] = []
        results['img_prefix'] = None
        results['seg_prefix'] = None
        if self.custom_classes:
            results['label_map'] = self.label_map

    def get_gt_seg_map_by_idx(self, index):
        """The label map of record ``index`` for evaluation: custom-class
        remapping, then reduce-zero, as ``CustomDataset``'s."""
        gt = imread(self.img_infos[index]['ann']['seg_map'], unchanged=True)
        if gt.ndim == 3:
            gt = gt[..., 0]
        if self.label_map is not None:
            out = gt.copy()
            for old_id, new_id in self.label_map.items():
                out[gt == old_id] = new_id
            gt = out
        if self.gt_loader_reduce_zero:
            gt = gt.astype(np.int32)
            gt[gt == 0] = 255
            gt = gt - 1
            gt[gt == 254] = 255
        return gt.astype(np.int32)
