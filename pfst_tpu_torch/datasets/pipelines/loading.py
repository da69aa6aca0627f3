"""Loading transforms (port of ``pfst_tpu/datasets/pipelines/loading.py``;
mirrors ``rsiseg/datasets/pipelines/loading.py``).

``imread`` reads a directory's pack first (``pipelines/packing.py``),
else decodes the file with the port's own PNG or TIFF reader, chosen by
its magic bytes (``pipelines/imdecode.py``), in cv2's conventions (BGR).
``LoadAnnotationsPseudoLabelsV2`` reads the HDF5 pseudo-label corpora of
``apis/pseudo_labels.py`` (and of the JAX tool) with the port's own HDF5
reader (``pipelines/h5.py``). ``LoadAnnotationsGTA`` and
``LoadAnnotationsDepth`` read their float maps unchanged: 16-bit
grayscale PNGs and float32 single-channel TIFFs. The JAX file's
decoded-tile LRU cache is not ported (packs make decoding a one-time
cost).
"""
from __future__ import annotations

import os.path as osp

import numpy as np

from ..builder import PIPELINES
from . import packing
from .h5 import read_h5
from .imdecode import read_image
from .transforms import imresize


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
    """Target-domain pseudo-label loader (``loading.py:185-239``; reference
    ``loading.py:393-525``). With ``pseudo_labels_dir=None`` (every shipped
    config) it emits an all-255 label, so the target branch has the source
    branch's keys. With a directory, it reads ``<image name>.h5`` there
    (the corpus of ``apis/pseudo_labels.py``): the stored logits'
    softmax, its argmax where its entropy is at most the argmax class's
    ``thre@{pseudo_ratio}`` and 255 elsewhere; a file without that key
    (say ``pseudo_ratio=0.0``) keeps every pixel, as the JAX loader does.
    A label of another size than the image is resized by nearest
    neighbour (cv2's INTER_NEAREST). With ``load_feats`` the maps named in
    ``sim_feat_names`` that the file holds go into ``results`` as (h, w,
    k*k) float32."""

    def __init__(self, pseudo_labels_dir=None, pseudo_ratio=0.0,
                 load_feats=False, reduce_zero_label=False,
                 sim_feat_names=('gaussian_sim_feat_2',), **kwargs):
        super().__init__(reduce_zero_label=reduce_zero_label)
        self.pseudo_labels_dir = pseudo_labels_dir
        self.pseudo_ratio = pseudo_ratio
        self.load_feats = load_feats
        self.sim_feat_names = list(sim_feat_names)

    def __call__(self, results):
        h, w = results['img'].shape[:2]
        if self.pseudo_labels_dir is None:
            results['gt_semantic_seg'] = np.full((h, w), 255, np.uint8)
            results['seg_fields'].append('gt_semantic_seg')
            return results
        name = osp.splitext(osp.basename(results['filename']))[0]
        thre_key = f'thre@{self.pseudo_ratio}'
        keys = ['seg_logits', thre_key]
        if self.load_feats:
            keys += self.sim_feat_names
        stored = read_h5(osp.join(self.pseudo_labels_dir, f'{name}.h5'),
                         keys)
        logits = stored['seg_logits'].astype(np.float32)     # (C, H, W)
        if self.load_feats:
            # precomputed maps for FMDAAdaptor's loss_sim_feat (reference
            # ``loading.py:497-503``), stored (h, w, k*k)
            for key in self.sim_feat_names:
                if key in stored:
                    results[key] = stored[key].astype(np.float32)
        e = np.exp(logits - logits.max(0, keepdims=True))
        prob = e / e.sum(0, keepdims=True)
        label = prob.argmax(0).astype(np.uint8)
        if thre_key in stored:
            thresholds = stored[thre_key].astype(np.float32)
            entropy = -(prob * np.log(prob + 1e-12)).sum(0)
            keep = entropy <= thresholds[label]
            label = np.where(keep, label, 255).astype(np.uint8)
        if label.shape != (h, w):
            label = imresize(label, (w, h), 'nearest')
        results['gt_semantic_seg'] = label
        results['seg_fields'].append('gt_semantic_seg')
        return results


@PIPELINES.register_module()
class LoadAnnotationsPseudoLabels(LoadAnnotationsPseudoLabelsV2):
    """V1 loader (``loading.py:310``): the same public behaviour."""


@PIPELINES.register_module()
class AnnotationMapperInria:
    """(``loading.py:247-256``) Inria's building labels 255 -> 1: every
    value above 127 is 1, the rest 0."""

    def __call__(self, results):
        gt = results['gt_semantic_seg']
        results['gt_semantic_seg'] = (gt > 127).astype(np.uint8)
        return results

    def __repr__(self):
        return f'{self.__class__.__name__}()'


def _seg_map_path(results):
    if results.get('seg_prefix', None) is not None:
        return osp.join(results['seg_prefix'],
                        results['ann_info']['seg_map'])
    return results['ann_info']['seg_map']


@PIPELINES.register_module()
class LoadAnnotationsGTA:
    """(``loading.py:259-285``) a height map read unchanged, divided by
    100, clipped to [0, 500], NaN to 0, as the float32 label map."""

    def __init__(self, reduce_zero_label=False, file_client_args=None,
                 imdecode_backend=None):
        self.reduce_zero_label = reduce_zero_label

    def __call__(self, results):
        gt = imread(_seg_map_path(results),
                    unchanged=True).astype(np.float32) / 100.
        gt = np.clip(gt, 0, 500)
        gt = np.nan_to_num(gt, nan=0.0)
        results['gt_semantic_seg'] = gt
        results['seg_fields'].append('gt_semantic_seg')
        return results

    def __repr__(self):
        return (f'{self.__class__.__name__}'
                f'(reduce_zero_label={self.reduce_zero_label})')


@PIPELINES.register_module()
class LoadAnnotationsDepth:
    """(``loading.py:288-313``) the above-ground-level map of the tile
    (``RGB`` -> ``AGL`` in the path) read unchanged, values above 400 to
    0, clipped to [0, 400], as the float32 label map."""

    def __init__(self, reduce_zero_label=False, file_client_args=None,
                 imdecode_backend=None):
        self.reduce_zero_label = reduce_zero_label

    def __call__(self, results):
        filename = _seg_map_path(results).replace('RGB', 'AGL')
        gt = imread(filename, unchanged=True).astype(np.float32)
        gt[gt > 400] = 0
        gt = np.clip(gt, 0, 400)
        results['gt_semantic_seg'] = gt
        results['seg_fields'].append('gt_semantic_seg')
        return results

    def __repr__(self):
        return (f'{self.__class__.__name__}'
                f'(reduce_zero_label={self.reduce_zero_label})')
