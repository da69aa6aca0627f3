"""DPT head on NCHW maps (port of ``DPTHead`` in
``pfst_tpu/models/decode_heads/point_rend.py:202-256``).

The JAX file's reassembly: per ViT tap a 1x1 conv to
``post_process_channels[i]`` (``reassemble.{i}``), a bilinear resize by
(4, 2, 1, 0.5) (the 0.5 a downscale without antialiasing, as
``pfst_tpu/ops/resize.py`` does it) and a 3x3 conv to ``channels``
(``project.{i}``), both with bias, no norm and no activation; then a
top-down fusion, each level's sum through a 3x3 ConvModule
(``fuse.{i}``), a last one (``head_conv``) and the classifier. mmseg's
DPT reads out the class token and reassembles by deconvolution; this
head keeps the JAX file's structure under its names (``reassemble{i}``,
``project{i}``, ``fuse{i}``, ``head_conv``). ``readout_type`` and
``embed_dims`` are accepted and unused, as in the JAX file.
"""
from __future__ import annotations

from typing import Sequence

import torch.nn as nn

from ...ops import resize
from ..builder import HEADS
from ..utils.layers import ConvModule
from .base import BaseDecodeHead

_NO_ACT = {'type': 'none'}
_SCALES = (4, 2, 1, 0.5)


@HEADS.register_module()
class DPTHead(BaseDecodeHead):

    def __init__(self, in_channels: Sequence[int] = (768,) * 4,
                 channels: int = 256, num_classes: int = 19,
                 embed_dims: int = 768,
                 post_process_channels: Sequence[int] = (96, 192, 384, 768),
                 readout_type: str = 'ignore', in_index=(0, 1, 2, 3),
                 input_transform='multiple_select', **kwargs):
        super().__init__(list(in_channels), channels, num_classes,
                         in_index=list(in_index),
                         input_transform=input_transform, **kwargs)
        del embed_dims, readout_type
        self.reassemble = nn.ModuleList(
            ConvModule(c, p, 1, act_cfg=_NO_ACT)
            for c, p in zip(in_channels, post_process_channels))
        self.project = nn.ModuleList(
            ConvModule(p, channels, 3, padding=1, act_cfg=_NO_ACT)
            for p in post_process_channels)
        self.fuse = nn.ModuleList(
            ConvModule(channels, channels, 3, padding=1,
                       norm_cfg=self.norm_cfg)
            for _ in range(len(in_channels) - 1))
        self.head_conv = ConvModule(channels, channels, 3, padding=1,
                                    norm_cfg=self.norm_cfg)

    def forward(self, inputs):
        pyramid = []
        for i, s in zip(self.in_index, _SCALES):
            y = self.reassemble[len(pyramid)](inputs[i])
            if s != 1:
                y = resize(y, scale_factor=s, mode='bilinear',
                           align_corners=self.align_corners)
            pyramid.append(self.project[len(pyramid)](y))
        out = pyramid[-1]
        for i in range(len(pyramid) - 2, -1, -1):
            out = resize(out, size=pyramid[i].shape[2:], mode='bilinear',
                         align_corners=self.align_corners)
            out = self.fuse[i](pyramid[i] + out)
        feats = self.head_conv(out)
        return self.cls_seg(feats), feats
