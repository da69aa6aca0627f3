"""Pyramid pooling and PSPNet's head (port of
``pfst_tpu/models/decode_heads/psp_head.py``): ``adaptive_avg_pool``,
``PPM`` (``:19-60``) and ``PSPHead`` (``:63-96``), the input beside its
PPM branches through the 3x3 ``bottleneck``, under mmseg's names
(``psp_modules.{j}.1``, ``bottleneck``, ``conv_seg``)."""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops import resize
from ..builder import HEADS
from ..utils.layers import ConvModule
from .base import BaseDecodeHead


def adaptive_avg_pool(x: torch.Tensor, out_size: int) -> torch.Tensor:
    """NCHW adaptive average pool to (out_size, out_size), torch's bin
    edges ``floor(i*S/O)`` to ``ceil((i+1)*S/O)``, which the JAX file
    reproduces."""
    return F.adaptive_avg_pool2d(x, out_size)


class _AdaptivePool(nn.Module):

    def __init__(self, out_size: int):
        super().__init__()
        self.out_size = out_size

    def forward(self, x):
        return adaptive_avg_pool(x, self.out_size)


class PPM(nn.ModuleList):
    """Pyramid Pooling Module: per scale, pool, 1x1 ConvModule and a
    bilinear resize back to the input; mmseg's keys ``{j}.1.conv``,
    ``{j}.1.bn``."""

    def __init__(self, pool_scales: Sequence[int], in_channels: int,
                 channels: int, align_corners: bool,
                 norm_cfg: Optional[dict] = None,
                 act_cfg: Optional[dict] = None):
        super().__init__(
            nn.Sequential(_AdaptivePool(s),
                          ConvModule(in_channels, channels, 1,
                                     norm_cfg=norm_cfg, act_cfg=act_cfg))
            for s in pool_scales)
        self.align_corners = align_corners

    def forward(self, x):
        return [resize(branch(x), size=x.shape[2:], mode='bilinear',
                       align_corners=self.align_corners) for branch in self]


@HEADS.register_module()
class PSPHead(BaseDecodeHead):

    def __init__(self, in_channels: int = 2048, channels: int = 512,
                 num_classes: int = 19,
                 pool_scales: Sequence[int] = (1, 2, 3, 6), in_index=3,
                 **kwargs):
        super().__init__(in_channels, channels, num_classes,
                         in_index=in_index, **kwargs)
        cfgs = dict(norm_cfg=self.norm_cfg, act_cfg=self.act_cfg)
        self.psp_modules = PPM(pool_scales, in_channels, channels,
                               self.align_corners, **cfgs)
        self.bottleneck = ConvModule(
            in_channels + len(pool_scales) * channels, channels, 3,
            padding=1, **cfgs)

    def forward(self, inputs):
        x = self._transform_inputs(inputs)
        feats = self.bottleneck(torch.cat([x, *self.psp_modules(x)], dim=1))
        return self.cls_seg(feats), feats
