"""ASPP heads: DeepLabV3 and DeepLabV3+ on NCHW tensors (port of
``pfst_tpu/models/decode_heads/aspp_head.py``).

Attribute names follow mmseg (``image_pool.1``, ``aspp_modules.i``,
``bottleneck``, ``c1_bottleneck``, ``sep_bottleneck.{0,1}``,
``conv_seg``). The returned ``decoded_features`` is the post-ASPP
bottleneck output *before* the c1 skip concat
(``sep_aspp_head.py:92``), the tensor the feature state and the PFGST
loss consume.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from ...ops import resize
from ..builder import HEADS
from ..utils.layers import ConvModule, DepthwiseSeparableConvModule
from .base import BaseDecodeHead


class ASPPModule(nn.ModuleList):
    """Parallel atrous branches (``aspp_head.py:11-50``)."""

    def __init__(self, dilations: Sequence[int], in_channels: int,
                 channels: int, norm_cfg=None, act_cfg=None,
                 separable: bool = False):
        branches = []
        for dilation in dilations:
            if dilation > 1 and separable:
                branches.append(DepthwiseSeparableConvModule(
                    in_channels, channels, 3, dilation=dilation,
                    padding=dilation, norm_cfg=norm_cfg, act_cfg=act_cfg))
            else:
                branches.append(ConvModule(
                    in_channels, channels, 1 if dilation == 1 else 3,
                    dilation=dilation,
                    padding=0 if dilation == 1 else dilation,
                    norm_cfg=norm_cfg, act_cfg=act_cfg))
        super().__init__(branches)

    def forward(self, x):
        return [branch(x) for branch in self]


@HEADS.register_module()
class ASPPHead(BaseDecodeHead):
    """DeepLabV3 head (``aspp_head.py:53-126``)."""
    separable = False

    def __init__(self, in_channels: int = 2048, channels: int = 512,
                 num_classes: int = 19,
                 dilations: Sequence[int] = (1, 6, 12, 18),
                 in_index=3, **kwargs):
        super().__init__(in_channels, channels, num_classes,
                         in_index=in_index, **kwargs)
        self.dilations = tuple(dilations)
        cfgs = dict(norm_cfg=self.norm_cfg, act_cfg=self.act_cfg)
        self.image_pool = nn.Sequential(
            nn.AdaptiveAvgPool2d(1),
            ConvModule(in_channels, channels, 1, **cfgs))
        self.aspp_modules = ASPPModule(self.dilations, in_channels, channels,
                                       separable=self.separable, **cfgs)
        self.bottleneck = ConvModule(
            (len(self.dilations) + 1) * channels, channels, 3, padding=1,
            **cfgs)

    def _aspp(self, x):
        pooled = resize(self.image_pool(x), size=x.shape[2:],
                        mode='bilinear', align_corners=self.align_corners)
        return self.bottleneck(torch.cat([pooled, *self.aspp_modules(x)],
                                         dim=1))

    def forward(self, inputs):
        feats = self._aspp(self._transform_inputs(inputs))
        return self.cls_seg(feats), feats


@HEADS.register_module()
class DepthwiseSeparableASPPHead(ASPPHead):
    """DeepLabV3+ head (``sep_aspp_head.py:30-111``)."""
    separable = True

    def __init__(self, c1_in_channels: int = 256, c1_channels: int = 48,
                 dilations: Sequence[int] = (1, 12, 24, 36), **kwargs):
        super().__init__(dilations=dilations, **kwargs)
        cfgs = dict(norm_cfg=self.norm_cfg, act_cfg=self.act_cfg)
        self.c1_bottleneck = ConvModule(
            c1_in_channels, c1_channels, 1, **cfgs) \
            if c1_in_channels > 0 else None
        ch = self.channels
        self.sep_bottleneck = nn.Sequential(
            DepthwiseSeparableConvModule(
                ch + (c1_channels if c1_in_channels > 0 else 0), ch, 3,
                padding=1, **cfgs),
            DepthwiseSeparableConvModule(ch, ch, 3, padding=1, **cfgs))

    def forward(self, inputs):
        output = self._aspp(self._transform_inputs(inputs))
        features = output  # pre-c1 decoded features (sep_aspp_head.py:92)
        if self.c1_bottleneck is not None:
            c1 = self.c1_bottleneck(inputs[0])
            output = resize(output, size=c1.shape[2:], mode='bilinear',
                            align_corners=self.align_corners)
            output = torch.cat([output, c1], dim=1)
        output = self.sep_bottleneck(output)
        return self.cls_seg(output), features
