"""ResNeSt backbone on NCHW tensors (port of
``pfst_tpu/models/backbones/resnest.py``).

The ported ResNet with the deep stem, average-pool downsampling and
split-attention bottlenecks: the 3x3 conv widens to ``radix`` groups of
channels, fused by a per-channel softmax over the radix from the pooled
sum (fc1, its BatchNorm, ReLU, fc2). As in the JAX file the bottleneck's
width is ``int(planes * base_width / base_channels) * groups``, every
depth takes ``BottleneckS``, and ``multi_grid``, ``with_cp`` and
``s2d_stem`` are not read. The split-attention conv keeps the JAX file's
names inside ``layerN.M.conv2`` (``conv``, a ConvModule, ``fc1``,
``fc1_bn``, ``fc2``), which the ResNet key map carries to the JAX tree;
the rest keeps mmseg's ResNet names.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..builder import BACKBONES
from ..utils.layers import ConvModule, Norm, norm_name
from .resnet import Bottleneck, ResNet, _conv, _downsample


class SplitAttentionConv(nn.Module):
    """(``resnest.py:19-53``) conv to ``channels * radix`` in ``groups *
    radix`` groups with its norm and ReLU, then the radix attention."""

    def __init__(self, in_channels, channels, kernel_size=3, stride=1,
                 dilation=1, groups=1, radix=2, reduction_factor=4,
                 norm_cfg=None):
        super().__init__()
        self.radix, self.channels = radix, channels
        self.conv = ConvModule(in_channels, channels * radix, kernel_size,
                               stride, dilation, dilation,
                               groups=groups * radix, norm_cfg=norm_cfg)
        inter = max(channels * radix // reduction_factor, 32)
        self.fc1 = nn.Linear(channels, inter)
        self.fc1_bn = nn.BatchNorm1d(inter, eps=1e-5, momentum=0.1)
        self.fc2 = nn.Linear(inter, channels * radix)

    def forward(self, x):
        y = self.conv(x)
        b, _, h, w = y.shape
        splits = y.view(b, self.radix, self.channels, h, w)
        gap = splits.sum(dim=1).mean(dim=(2, 3))
        att = self.fc2(F.relu(self.fc1_bn(self.fc1(gap))))
        att = torch.softmax(att.view(b, self.radix, self.channels), dim=1)
        return (splits * att[..., None, None]).sum(dim=1)


class BottleneckS(Bottleneck):
    """1x1, split-attention 3x3, 3x3/s average pool where the block
    strides, 1x1 (``resnest.py:56-104``)."""

    def __init__(self, inplanes, planes, stride=1, dilation=1,
                 with_downsample=False, avg_down=True, norm_cfg=None,
                 groups=1, base_width=4, base_channels=64, radix=2):
        nn.Module.__init__(self)
        width = int(planes * (base_width / base_channels)) * groups
        n = norm_name(norm_cfg)
        self.norm_names = (f'{n}1', f'{n}3')
        self.conv1 = _conv(inplanes, width, 1)
        self.add_module(self.norm_names[0], Norm(width, norm_cfg))
        self.conv2 = SplitAttentionConv(width, width, 3, 1, dilation,
                                        groups, radix, norm_cfg=norm_cfg)
        self.avd_layer = nn.AvgPool2d(3, stride, 1) if stride > 1 else None
        self.conv3 = _conv(width, planes * self.expansion, 1)
        self.add_module(self.norm_names[1],
                        Norm(planes * self.expansion, norm_cfg))
        self.downsample = _downsample(
            inplanes, planes * self.expansion, stride, avg_down,
            norm_cfg) if with_downsample else None

    def forward(self, x):
        n1, n3 = (getattr(self, n) for n in self.norm_names)
        out = self.conv2(F.relu(n1(self.conv1(x))))
        if self.avd_layer is not None:
            out = self.avd_layer(out)
        out = n3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


@BACKBONES.register_module()
class ResNeSt(ResNet):
    """ResNet with ``BottleneckS`` blocks, the deep stem and average-pool
    downsampling (``resnest.py:107-151``)."""
    default_deep_stem = True
    default_avg_down = True

    def __init__(self, groups: int = 1, base_width: int = 4, radix: int = 2,
                 **kwargs):
        self._block_kw = dict(groups=groups, base_width=base_width,
                              base_channels=kwargs.get('base_channels', 64),
                              radix=radix)
        kwargs.update(deep_stem=True, multi_grid=None, with_cp=False,
                      s2d_stem=False)
        kwargs.setdefault('avg_down', True)
        super().__init__(**kwargs)

    @property
    def arch_settings(self):
        return {d: (BottleneckS, blocks)
                for d, (_, blocks) in ResNet.arch_settings.items()}

    def _block(self, block_cls, inplanes, planes, stride, dilation,
               with_downsample, avg_down, norm_cfg):
        return block_cls(inplanes, planes, stride, dilation,
                         with_downsample, avg_down, norm_cfg,
                         **self._block_kw)
