"""Loading transforms (port of ``pfst_tpu/datasets/pipelines/loading.py``;
mirrors ``rsiseg/datasets/pipelines/loading.py``).

``imread`` reads a directory's pack first (``pipelines/packing.py``),
else decodes the file with the port's own PNG or TIFF reader, chosen by
its magic bytes (``pipelines/imdecode.py``), in cv2's conventions (BGR). The JAX file's decoded-tile LRU cache is not
ported (packs make decoding a one-time cost); the h5 pseudo-label corpora
of ``LoadAnnotationsPseudoLabelsV2`` wait for ROADMAP A12.
"""
from __future__ import annotations

import os.path as osp

import numpy as np

from ..builder import PIPELINES
from . import packing
from .imdecode import read_image


def imread(path: str, color: bool = True, unchanged: bool = False):
    """Read an image as ``cv2.imread`` would: BGR uint8 for ``color``,
    (H, W) for a grayscale read, the stored channels for ``unchanged``."""
    packed = packing.lookup(path, color, unchanged)
    if packed is not None:
        return packed
    if not osp.isfile(path):
        raise FileNotFoundError(f'failed to read image: {path}')
    mode = 'unchanged' if unchanged else ('color' if color else 'grayscale')
    return read_image(path, mode)


@PIPELINES.register_module()
class LoadImageFromFile:
    """(``loading.py:15``) loads BGR uint8, or with
    ``color_type='unchanged'`` the stored dtype and channels."""

    def __init__(self, to_float32=False, color_type='color',
                 imdecode_backend='cv2'):
        self.to_float32 = to_float32
        self.color_type = color_type

    def __call__(self, results):
        if results.get('img_prefix') is not None:
            filename = osp.join(results['img_prefix'],
                                results['img_info']['filename'])
        else:
            filename = results['img_info']['filename']
        img = imread(filename, unchanged=self.color_type == 'unchanged')
        if self.to_float32:
            img = img.astype(np.float32)
        results['filename'] = filename
        results['ori_filename'] = results['img_info']['filename']
        results['img'] = img
        results['img_shape'] = img.shape
        results['ori_shape'] = img.shape
        results['pad_shape'] = img.shape
        results['scale_factor'] = 1.0
        num_channels = 1 if len(img.shape) < 3 else img.shape[2]
        results['img_norm_cfg'] = dict(
            mean=np.zeros(num_channels, dtype=np.float32),
            std=np.ones(num_channels, dtype=np.float32),
            to_rgb=False)
        results['img_fields'] = ['img']
        results.setdefault('seg_fields', [])
        return results

    def __repr__(self):
        return f'{self.__class__.__name__}(to_float32={self.to_float32})'


@PIPELINES.register_module()
class LoadAnnotations:
    """(``loading.py:101``) loads the label map, applies label_map and
    reduce_zero_label (0 -> 255, x -> x - 1)."""

    def __init__(self, reduce_zero_label=False, imdecode_backend=None):
        self.reduce_zero_label = reduce_zero_label

    def __call__(self, results):
        if results.get('seg_prefix', None) is not None:
            filename = osp.join(results['seg_prefix'],
                                results['ann_info']['seg_map'])
        else:
            filename = results['ann_info']['seg_map']
        gt = imread(filename, unchanged=True)
        if gt.ndim == 3:
            gt = gt[..., 0]
        gt = gt.astype(np.uint8)
        if results.get('label_map', None) is not None:
            out = gt.copy()
            for old_id, new_id in results['label_map'].items():
                out[gt == old_id] = new_id
            gt = out
        if self.reduce_zero_label:
            gt[gt == 0] = 255
            gt = gt - 1
            gt[gt == 254] = 255
        results['gt_semantic_seg'] = gt
        results['seg_fields'].append('gt_semantic_seg')
        return results

    def __repr__(self):
        return (f'{self.__class__.__name__}'
                f'(reduce_zero_label={self.reduce_zero_label})')


@PIPELINES.register_module()
class LoadAnnotationsPseudoLabelsV2(LoadAnnotations):
    """Target-domain pseudo-label loader (``loading.py:393-525``). With
    ``pseudo_labels_dir=None`` (every shipped config) it emits an all-255
    label, so the target branch has the source branch's keys. Reading the
    offline generator's h5 corpora waits for ROADMAP A12 and raises."""

    def __init__(self, pseudo_labels_dir=None, pseudo_ratio=0.0,
                 load_feats=False, reduce_zero_label=False,
                 sim_feat_names=('gaussian_sim_feat_2',), **kwargs):
        super().__init__(reduce_zero_label=reduce_zero_label)
        if pseudo_labels_dir is not None or load_feats:
            raise NotImplementedError(
                'pseudo-label h5 corpora (pseudo_labels_dir, load_feats) '
                'are not ported (ROADMAP A12)')
        self.pseudo_ratio = pseudo_ratio

    def __call__(self, results):
        h, w = results['img'].shape[:2]
        results['gt_semantic_seg'] = np.full((h, w), 255, np.uint8)
        results['seg_fields'].append('gt_semantic_seg')
        return results
