"""ICNet's cascade feature fusion (port of ``ICNeck`` in
``pfst_tpu/models/necks/necks.py:142-176``).

Each fusion resizes the smaller map bilinearly to the bigger one's size,
runs it through a 3x3 conv of dilation 2 and the bigger map through a
1x1 conv (both without activation), and takes the ReLU of their sum:
first the high branch into the middle one, then that into the low one.
Returns ``(out_low, out_mid, high)``, the high input passed through.
Module names are the JAX file's (``cff{i}_small``, ``cff{i}_big``),
mapped by ``core.convert``'s ``cnn`` family.
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
class ICNeck(nn.Module):

    key_family = 'cnn'      # core.convert's key map

    def __init__(self, in_channels: Sequence[int] = (64, 256, 256),
                 out_channels: int = 128, align_corners: bool = False,
                 norm_cfg: Optional[dict] = None):
        super().__init__()
        self.align_corners = align_corners
        low, mid, high = in_channels
        for i, (small, big) in enumerate(((high, mid), (out_channels, low))):
            self.add_module(f'cff{i}_small', ConvModule(
                small, out_channels, 3, padding=2, dilation=2,
                norm_cfg=norm_cfg, act_cfg=_NO_ACT))
            self.add_module(f'cff{i}_big', ConvModule(
                big, out_channels, 1, norm_cfg=norm_cfg, act_cfg=_NO_ACT))
        self.feature_channels = (out_channels, out_channels, high)

    def _cff(self, small, big, i):
        small = resize(small, size=big.shape[2:], mode='bilinear',
                       align_corners=self.align_corners)
        return F.relu(getattr(self, f'cff{i}_small')(small)
                      + getattr(self, f'cff{i}_big')(big))

    def forward(self, inputs):
        low, mid, high = inputs
        out_mid = self._cff(high, mid, 0)
        return self._cff(out_mid, low, 1), out_mid, high
