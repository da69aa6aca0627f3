"""FastFCN's joint pyramid upsampling (port of ``JPU`` in
``pfst_tpu/models/necks/necks.py:105-139``).

Every input through a 3x3 ConvModule (``conv{i}``), resized bilinearly
to the first one's size and concatenated; that through one
depthwise-separable 3x3 ConvModule a dilation (``dilated{i}``), their
outputs concatenated. Returns the inputs but the last, then that map.
As in the JAX file, every input is convolved: ``start_level`` and
``end_level`` are accepted and unused. Module names are the JAX file's,
mapped by ``core.convert``'s ``cnn`` family.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from ...ops import resize
from ..builder import NECKS
from ..utils.layers import ConvModule, DepthwiseSeparableConvModule


@NECKS.register_module()
class JPU(nn.Module):

    key_family = 'cnn'      # core.convert's key map

    def __init__(self, in_channels: Sequence[int] = (512, 1024, 2048),
                 mid_channels: int = 512, start_level: int = 0,
                 end_level: int = -1,
                 dilations: Sequence[int] = (1, 2, 4, 8),
                 align_corners: bool = False,
                 norm_cfg: Optional[dict] = None):
        super().__init__()
        del start_level, end_level
        self.align_corners = align_corners
        for i, c in enumerate(in_channels):
            self.add_module(f'conv{i}', ConvModule(
                c, mid_channels, 3, padding=1, norm_cfg=norm_cfg))
        self.n_dil = len(dilations)
        for i, d in enumerate(dilations):
            self.add_module(f'dilated{i}', DepthwiseSeparableConvModule(
                len(in_channels) * mid_channels, mid_channels, 3, padding=d,
                dilation=d, norm_cfg=norm_cfg))
        self.feature_channels = tuple(in_channels[:-1]) + (
            self.n_dil * mid_channels,)

    def forward(self, inputs):
        feats = [getattr(self, f'conv{i}')(x) for i, x in enumerate(inputs)]
        size = feats[0].shape[2:]
        cat = torch.cat([resize(f, size=size, mode='bilinear',
                                align_corners=self.align_corners)
                         for f in feats], dim=1)
        out = torch.cat([getattr(self, f'dilated{i}')(cat)
                         for i in range(self.n_dil)], dim=1)
        return tuple(inputs[:-1]) + (out,)
