"""Feature Pyramid Network neck on NCHW maps (port of ``FPN`` in
``pfst_tpu/models/necks/necks.py:15-54``).

The levels ``start_level`` to ``end_level`` through 1x1 ConvModules
without activation (``lateral_convs.{i}``), a top-down sum with each
deeper level resized to the next by ``resize(mode='nearest')`` (torch's
legacy floor rule), then 3x3 ConvModules without activation
(``fpn_convs.{i}``); up to ``num_outs`` outputs, each extra one a 1x1 max
pool with stride 2 of the last. mmseg's names. Like the JAX file,
``add_extra_convs`` is accepted and unused.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch.nn as nn
import torch.nn.functional as F

from ...ops import resize
from ..builder import NECKS
from ..utils.layers import ConvModule

_NO_ACT = {'type': 'none'}


@NECKS.register_module()
class FPN(nn.Module):
    key_family = 'fpn'      # core.convert's key map

    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 256, num_outs: int = 4,
                 start_level: int = 0, end_level: int = -1,
                 add_extra_convs: bool = False,
                 norm_cfg: Optional[dict] = None,
                 act_cfg: Optional[dict] = None):
        super().__init__()
        del add_extra_convs, act_cfg
        end = len(in_channels) if end_level == -1 else end_level
        self.start_level, self.end_level = start_level, end
        self.num_outs = num_outs
        used = in_channels[start_level:end]
        self.lateral_convs = nn.ModuleList(
            ConvModule(c, out_channels, 1, norm_cfg=norm_cfg,
                       act_cfg=_NO_ACT) for c in used)
        self.fpn_convs = nn.ModuleList(
            ConvModule(out_channels, out_channels, 3, padding=1,
                       norm_cfg=norm_cfg, act_cfg=_NO_ACT) for _ in used)

    def forward(self, inputs):
        used = list(inputs[self.start_level:self.end_level])
        laterals = [conv(x) for conv, x in zip(self.lateral_convs, used)]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + resize(
                laterals[i], size=laterals[i - 1].shape[2:], mode='nearest')
        outs = [conv(x) for conv, x in zip(self.fpn_convs, laterals)]
        while len(outs) < self.num_outs:
            outs.append(F.max_pool2d(outs[-1], 1, stride=2))
        return tuple(outs)
