"""ResNeXt backbone on NCHW tensors (port of
``pfst_tpu/models/backbones/resnext.py``).

The ported ResNet with grouped 3x3 bottlenecks of width
``floor(planes * base_width / base_channels) * groups``. As in the JAX
file, every depth takes ``BottleneckX`` and the 7x7 stem (``deep_stem``,
``multi_grid``, ``with_cp`` and ``s2d_stem`` are not read). mmseg's key
names are the ResNet's (``layerN.M.conv2`` the grouped conv), which the
ResNet key map carries.
"""
from __future__ import annotations

import math

import torch.nn as nn

from ..builder import BACKBONES
from ..utils.layers import Norm, norm_name
from .resnet import Bottleneck, ResNet, _conv, _downsample


class BottleneckX(Bottleneck):
    """1x1, grouped 3x3 (stride and dilation here), 1x1 (``resnext.py:19-
    54``)."""

    def __init__(self, inplanes, planes, stride=1, dilation=1,
                 with_downsample=False, avg_down=False, norm_cfg=None,
                 groups=32, base_width=4, base_channels=64):
        nn.Module.__init__(self)
        width = math.floor(planes * (base_width / base_channels)) * groups
        n = norm_name(norm_cfg)
        self.norm_names = (f'{n}1', f'{n}2', f'{n}3')
        self.conv1 = _conv(inplanes, width, 1)
        self.add_module(self.norm_names[0], Norm(width, norm_cfg))
        self.conv2 = nn.Conv2d(width, width, 3, stride, dilation, dilation,
                               groups=groups, bias=False)
        self.add_module(self.norm_names[1], Norm(width, norm_cfg))
        self.conv3 = _conv(width, planes * self.expansion, 1)
        self.add_module(self.norm_names[2],
                        Norm(planes * self.expansion, norm_cfg))
        self.downsample = _downsample(
            inplanes, planes * self.expansion, stride, avg_down,
            norm_cfg) if with_downsample else None


@BACKBONES.register_module()
class ResNeXt(ResNet):
    """ResNet with ``BottleneckX`` blocks (``resnext.py:57-97``)."""

    def __init__(self, groups: int = 32, base_width: int = 4, **kwargs):
        self._block_kw = dict(groups=groups, base_width=base_width,
                              base_channels=kwargs.get('base_channels', 64))
        kwargs.update(deep_stem=False, multi_grid=None, with_cp=False,
                      s2d_stem=False)
        super().__init__(**kwargs)

    @property
    def arch_settings(self):
        return {d: (BottleneckX, blocks)
                for d, (_, blocks) in ResNet.arch_settings.items()}

    def _block(self, block_cls, inplanes, planes, stride, dilation,
               with_downsample, avg_down, norm_cfg):
        return block_cls(inplanes, planes, stride, dilation,
                         with_downsample, avg_down, norm_cfg,
                         **self._block_kw)
