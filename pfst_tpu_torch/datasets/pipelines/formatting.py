"""Formatting transforms (port of
``pfst_tpu/datasets/pipelines/formatting.py``; mirrors
``rsiseg/datasets/pipelines/formating.py``).

Images leave the pipeline as CHW numpy arrays, the port's NCHW layout
(the JAX file keeps HWC for NHWC). Without deferred normalization they
are float32; with it (``DeferNormalize``) they keep their uint8 or
float16 wire dtype. Label maps are (H, W) int32.
"""
from __future__ import annotations

import numpy as np

from ..builder import PIPELINES

DEFAULT_META_KEYS = ('filename', 'ori_filename', 'ori_shape', 'img_shape',
                     'pad_shape', 'scale_factor', 'flip',
                     'flip_direction', 'img_norm_cfg', 'rotate_k',
                     'crop_bbox')


def _to_chw(img, deferred):
    if img.ndim == 2:
        img = img[..., None]
    return np.ascontiguousarray(img.transpose(2, 0, 1),
                                img.dtype if deferred else np.float32)


def _deferred(results):
    return bool(results.get('img_norm_cfg', {}).get('deferred'))


@PIPELINES.register_module()
class DefaultFormatBundle:
    """Images -> CHW (float32 unless deferred); label maps -> int32. With
    a clean snapshot (``KeepOriImage``) it formats ``ori_img`` too and
    adds its replay metas as stackable int32 arrays: ``rotate_k``,
    ``flip_horizontal`` and ``flip_vertical`` (``formatting.py:44-56``)."""

    def __call__(self, results):
        deferred = _deferred(results)
        for key in results.get('img_fields', ['img']):
            results[key] = _to_chw(results[key], deferred)
        for key in results.get('seg_fields', []):
            results[key] = np.ascontiguousarray(results[key], np.int32)
        if 'ori_img' in results:
            results['ori_img'] = _to_chw(results['ori_img'], deferred)
            results['rotate_k'] = np.asarray(results.get('rotate_k', 0),
                                             np.int32)
            flip = bool(results.get('flip', False))
            direction = results.get('flip_direction') or 'horizontal'
            results['flip_horizontal'] = np.asarray(
                int(flip and 'horizontal' in direction), np.int32)
            results['flip_vertical'] = np.asarray(
                int(flip and 'vertical' in direction), np.int32)
        return results

    def __repr__(self):
        return self.__class__.__name__


@PIPELINES.register_module()
class ImageToTensor:
    """The images named in ``keys`` -> CHW (float32 unless deferred)."""

    def __init__(self, keys):
        self.keys = keys

    def __call__(self, results):
        deferred = _deferred(results)
        for key in self.keys:
            results[key] = _to_chw(results[key], deferred)
        return results

    def __repr__(self):
        return f'{self.__class__.__name__}(keys={self.keys})'


@PIPELINES.register_module()
class Collect:
    """(``formating.py:224``) keep the data keys and pack the metas."""

    def __init__(self, keys, meta_keys=DEFAULT_META_KEYS):
        self.keys = keys
        self.meta_keys = meta_keys

    def __call__(self, results):
        data = {'img_metas': {k: results[k] for k in self.meta_keys
                              if k in results}}
        for key in self.keys:
            data[key] = results[key]
        return data

    def __repr__(self):
        return (f'{self.__class__.__name__}(keys={self.keys}, '
                f'meta_keys={self.meta_keys})')
