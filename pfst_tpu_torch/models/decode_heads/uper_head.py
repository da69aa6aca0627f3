"""UPerNet head on NCHW maps (port of
``pfst_tpu/models/decode_heads/uper_head.py:19-86``).

PPM on the deepest level, top-down fusion over all levels, the levels
resized to the finest and fused by ``fpn_bottleneck``; returns
``(logits, decoded_features)``. mmseg's names: ``psp_modules.{j}.1``,
``bottleneck``, ``lateral_convs.{i}``, ``fpn_convs.{i}``,
``fpn_bottleneck``, ``conv_seg`` (the JAX file's ``ppm/pool{j}``,
``psp_bottleneck``, ``lateral{i}``, ``fpn_conv{i}``, ``fpn_bottleneck``,
``cls/conv_seg``). Like the JAX file it selects ``in_index`` and ignores
``input_transform``.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from ...ops import resize
from ..builder import HEADS
from ..utils.layers import ConvModule
from .base import BaseDecodeHead
from .psp_head import PPM


@HEADS.register_module()
class UPerHead(BaseDecodeHead):

    def __init__(self, in_channels: Sequence[int] = (96, 192, 384, 768),
                 channels: int = 512, num_classes: int = 19,
                 pool_scales: Sequence[int] = (1, 2, 3, 6),
                 in_index=(0, 1, 2, 3), input_transform='multiple_select',
                 **kwargs):
        super().__init__(list(in_channels), channels, num_classes,
                         in_index=list(in_index),
                         input_transform=input_transform, **kwargs)
        cfgs = dict(norm_cfg=self.norm_cfg, act_cfg=self.act_cfg)
        self.psp_modules = PPM(pool_scales, in_channels[-1], channels,
                               self.align_corners, **cfgs)
        self.bottleneck = ConvModule(
            in_channels[-1] + len(pool_scales) * channels, channels, 3,
            padding=1, **cfgs)
        self.lateral_convs = nn.ModuleList(
            ConvModule(c, channels, 1, **cfgs) for c in in_channels[:-1])
        self.fpn_convs = nn.ModuleList(
            ConvModule(channels, channels, 3, padding=1, **cfgs)
            for _ in in_channels[:-1])
        self.fpn_bottleneck = ConvModule(len(in_channels) * channels,
                                         channels, 3, padding=1, **cfgs)

    def forward(self, inputs):
        feats = [inputs[i] for i in self.in_index]
        top = self.bottleneck(torch.cat(
            [feats[-1], *self.psp_modules(feats[-1])], dim=1))
        laterals = [conv(f) for conv, f in zip(self.lateral_convs,
                                               feats)] + [top]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + resize(
                laterals[i], size=laterals[i - 1].shape[2:], mode='bilinear',
                align_corners=self.align_corners)
        fpn_outs = [conv(x) for conv, x in zip(self.fpn_convs,
                                               laterals)] + [laterals[-1]]
        size0 = fpn_outs[0].shape[2:]
        fpn_outs = [resize(f, size=size0, mode='bilinear',
                           align_corners=self.align_corners)
                    for f in fpn_outs]
        feats_out = self.fpn_bottleneck(torch.cat(fpn_outs, dim=1))
        return self.cls_seg(feats_out), feats_out
