"""SegFormer's all-MLP head on NCHW maps (port of
``pfst_tpu/models/decode_heads/segformer_head.py:15-52``).

Each level through a 1x1 ``ConvModule`` to ``channels`` (``act_cfg`` None
means ReLU, as in the JAX ``ConvModule``), resized to level 0, the levels
concatenated and fused by a 1x1 ``ConvModule``; returns ``(logits,
fused)``, so the feature state reads the fused map at level 0's stride.
mmseg's names: ``convs.{i}``, ``fusion_conv``, ``conv_seg`` (the JAX
file's ``proj{i}``, ``fusion``, ``cls/conv_seg``; ``core.convert`` tells
this head's ``convs`` from an FCN head's by its ``fusion_conv``). Like the
JAX file it selects ``in_index`` and ignores ``input_transform``.
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
class SegformerHead(BaseDecodeHead):

    def __init__(self, in_channels: Sequence[int] = (32, 64, 160, 256),
                 channels: int = 256, num_classes: int = 19,
                 in_index=(0, 1, 2, 3), input_transform='multiple_select',
                 interpolate_mode: str = 'bilinear', **kwargs):
        super().__init__(list(in_channels), channels, num_classes,
                         in_index=list(in_index),
                         input_transform=input_transform, **kwargs)
        self.interpolate_mode = interpolate_mode
        cfgs = dict(norm_cfg=self.norm_cfg, act_cfg=self.act_cfg)
        self.convs = nn.ModuleList(ConvModule(c, channels, 1, **cfgs)
                                   for c in in_channels)
        self.fusion_conv = ConvModule(len(in_channels) * channels, channels,
                                      1, **cfgs)

    def forward(self, inputs):
        feats = [inputs[i] for i in self.in_index]
        size0 = feats[0].shape[2:]
        fused = self.fusion_conv(torch.cat(
            [resize(conv(f), size=size0, mode=self.interpolate_mode,
                    align_corners=self.align_corners)
             for conv, f in zip(self.convs, feats)], dim=1))
        return self.cls_seg(fused), fused
