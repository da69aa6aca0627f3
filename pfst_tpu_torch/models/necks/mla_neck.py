"""MLA neck of SETR-MLA on NCHW maps (port of ``MLANeck`` in
``pfst_tpu/models/necks/necks.py:179-207``).

The JAX file's aggregation: per level a 1x1 ConvModule (``lateral.{i}``),
their top-down cumulative sums (level i gets the sum of levels i and
deeper), then a 3x3 ConvModule a level (``conv.{i}``); with the defs'
``norm_cfg`` of None both have a bias, no norm and a ReLU. mmseg's
neck normalises each level first and nests its convs under ``mla``; this
one keeps the JAX file's structure and names (``lateral{i}``,
``conv{i}``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch.nn as nn

from ..builder import NECKS
from ..utils.layers import ConvModule


@NECKS.register_module()
class MLANeck(nn.Module):
    key_family = 'mla'      # core.convert's key map

    def __init__(self, in_channels: Sequence[int] = (1024,) * 4,
                 out_channels: int = 256, norm_cfg: Optional[dict] = None,
                 act_cfg: Optional[dict] = None):
        super().__init__()
        # the JAX file passes norm_cfg to its convs and not act_cfg
        del act_cfg
        self.lateral = nn.ModuleList(
            ConvModule(c, out_channels, 1, norm_cfg=norm_cfg)
            for c in in_channels)
        self.conv = nn.ModuleList(
            ConvModule(out_channels, out_channels, 3, padding=1,
                       norm_cfg=norm_cfg) for _ in in_channels)

    def forward(self, inputs):
        laterals = [lateral(x) for lateral, x in zip(self.lateral, inputs)]
        for i in range(len(laterals) - 2, -1, -1):
            laterals[i] = laterals[i + 1] + laterals[i]
        return tuple(conv(x) for conv, x in zip(self.conv, laterals))
