"""Lite R-ASPP head for MobileNetV3 (port of
``pfst_tpu/models/decode_heads/lraspp_head.py``).

The deepest input through the 1x1 ``ConvModule`` ``conv_up``, gated by a
sigmoid of a 1x1 conv (``image_pool_conv``, with a bias) of its pooled
input; then for each shallower input, from the deepest: a bilinear resize
to it, its 1x1 ``lateral{i}`` conv (``branch_channels`` reversed)
concatenated, and the 1x1 ``ConvModule`` ``fuse{i}``. The classifier is
a plain 1x1 conv with no dropout (``dropout_ratio`` is accepted and
unused, as in the JAX file). Returns ``(logits, features)``, the
features at the shallowest input's resolution. The names are the JAX
file's, its classifier directly ``conv_seg``; ``core.convert`` tells the
head by its ``conv_up``.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from ...ops import resize
from ..builder import HEADS
from ..utils.layers import ConvModule
from .base import BaseDecodeHead


@HEADS.register_module()
class LRASPPHead(BaseDecodeHead):

    def __init__(self, in_channels: Sequence[int] = (16, 24, 960),
                 channels: int = 128, num_classes: int = 19,
                 branch_channels: Sequence[int] = (32, 64),
                 in_index=(0, 1, 2), input_transform='multiple_select',
                 **kwargs):
        kwargs['dropout_ratio'] = 0.0
        super().__init__(list(in_channels), channels, num_classes,
                         in_index=list(in_index),
                         input_transform=input_transform, **kwargs)
        cfgs = dict(norm_cfg=self.norm_cfg)
        self.conv_up = ConvModule(in_channels[-1], channels, 1, **cfgs)
        self.image_pool_conv = nn.Conv2d(in_channels[-1], channels, 1)
        lows = list(in_channels[:-1])[::-1]
        branches = list(branch_channels)[::-1]
        self.lateral = nn.ModuleList(
            nn.Conv2d(c, branches[i], 1) for i, c in enumerate(lows))
        self.fuse = nn.ModuleList(
            ConvModule(channels + branches[i], channels, 1, **cfgs)
            for i in range(len(lows)))

    def forward(self, inputs):
        feats = [inputs[i] for i in self.in_index]
        x = feats[-1]
        s = self.image_pool_conv(x.mean(dim=(2, 3), keepdim=True))
        out = self.conv_up(x) * torch.sigmoid(s)
        for lateral, fuse, low in zip(self.lateral, self.fuse,
                                      feats[:-1][::-1]):
            out = resize(out, size=low.shape[2:], mode='bilinear',
                         align_corners=self.align_corners)
            out = fuse(torch.cat([out, lateral(low)], dim=1))
        return self.cls_seg(out), out
