"""MultiLevelNeck on NCHW maps (port of ``MultiLevelNeck`` in
``pfst_tpu/models/necks/necks.py:56-82``).

Rescales single- or multi-level ViT features: per level a 1x1 conv
(``lateral_convs.{i}``), a bilinear resize by ``scales[i]`` and a 3x3 conv
(``convs.{i}``), both with bias, no norm and no activation, under mmseg's
names.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch.nn as nn

from ...ops import resize
from ..builder import NECKS
from ..utils.layers import ConvModule

_NO_ACT = {'type': 'none'}


@NECKS.register_module()
class MultiLevelNeck(nn.Module):

    def __init__(self,
                 in_channels: Sequence[int] = (768,) * 4,
                 out_channels: int = 768,
                 scales: Sequence[float] = (0.5, 1, 2, 4),
                 norm_cfg: Optional[dict] = None,
                 act_cfg: Optional[dict] = None):
        super().__init__()
        # the JAX file builds its convs without norm_cfg and act_cfg
        del norm_cfg, act_cfg
        self.scales = tuple(scales)
        self.lateral_convs = nn.ModuleList(
            ConvModule(c, out_channels, 1, act_cfg=_NO_ACT)
            for c in in_channels)
        self.convs = nn.ModuleList(
            ConvModule(out_channels, out_channels, 3, padding=1,
                       act_cfg=_NO_ACT) for _ in self.scales)

    def forward(self, inputs):
        inputs = list(inputs)
        if len(inputs) == 1:
            inputs = inputs * len(self.scales)
        outs = []
        for x, s, lateral, conv in zip(inputs, self.scales,
                                       self.lateral_convs, self.convs):
            x = lateral(x)
            if s != 1:
                x = resize(x, scale_factor=s, mode='bilinear',
                           align_corners=False)
            outs.append(conv(x))
        return tuple(outs)
