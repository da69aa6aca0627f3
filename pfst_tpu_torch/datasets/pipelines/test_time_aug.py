"""Multi-scale flip test-time augmentation (port of
``pfst_tpu/datasets/pipelines/test_time_aug.py``; mirrors
``rsiseg/datasets/pipelines/test_time_aug.py:10``).

In ratio mode (``img_scale=None``) the views' scales are the image's size
times each ratio, set as ``scale`` as mmseg does; the JAX file hands
``Resize`` the ratio as ``scale_factor`` instead (ROADMAP C2).
"""
from __future__ import annotations

import copy

import numpy as np

from ..builder import PIPELINES
from .compose import Compose


@PIPELINES.register_module()
class MultiScaleFlipAug:

    def __init__(self, transforms, img_scale=None, img_ratios=None,
                 flip=False, flip_direction='horizontal'):
        self.transforms = Compose(transforms)
        if img_ratios is not None:
            img_ratios = img_ratios if isinstance(img_ratios, list) \
                else [img_ratios]
        if img_scale is None:
            self.img_scale = None
            self.img_ratios = img_ratios or [1.0]
        elif isinstance(img_scale, tuple) and img_ratios is not None:
            self.img_scale = [(int(img_scale[0] * r),
                               int(img_scale[1] * r)) for r in img_ratios]
        else:
            self.img_scale = img_scale if isinstance(img_scale, list) \
                else [img_scale]
        self.flip = flip
        self.flip_direction = flip_direction if isinstance(
            flip_direction, list) else [flip_direction]

    def __call__(self, results):
        if self.img_scale is None:
            h, w = results['img'].shape[:2]
            scales = [(int(w * r), int(h * r)) for r in self.img_ratios]
        else:
            scales = self.img_scale
        flip_args = [(False, None)]
        if self.flip:
            flip_args += [(True, d) for d in self.flip_direction]
        aug_data = []
        for scale in scales:
            for do_flip, direction in flip_args:
                _results = copy.deepcopy(results)
                _results['scale'] = scale
                _results['flip'] = do_flip
                _results['flip_direction'] = direction
                data = self.transforms(_results)
                if do_flip:
                    # CHW images: the width is the last axis
                    axis = -1 if direction == 'horizontal' else -2
                    data['img'] = np.flip(data['img'], axis=axis).copy()
                aug_data.append(data)
        return {key: [d[key] for d in aug_data] for key in aug_data[0]}

    def __repr__(self):
        return (f'{self.__class__.__name__}(img_scale={self.img_scale}, '
                f'flip={self.flip})')
