"""Pyramid pooling (port of ``adaptive_avg_pool`` and ``PPM`` in
``pfst_tpu/models/decode_heads/psp_head.py:19-60``). ``PSPHead`` itself
is not ported yet."""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops import resize
from ..utils.layers import ConvModule


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
