"""Asymmetric non-local head on NCHW maps (port of ``ANNHead`` in
``pfst_tpu/models/decode_heads/context_heads.py:151-195``).

The JAX file's single asymmetric attention, not mmseg's AFNB and APNB:
the deepest level through a 3x3 ConvModule (``high_in``); queries from
a 1x1 conv (``q``) at every pixel, keys and values (``k``, ``v``) from
the 1 + 9 + 36 + 64 adaptive average pools of the same map; their
attention, a 1x1 ConvModule without activation (``out_proj``), a
residual sum and a 3x3 ConvModule (``bottleneck``). The JAX file's
names. The first selected level is read and unused, as in the JAX file.
The attention is the JAX file's ``einsum`` formula, fp32 scores and
softmax, P rounded to v's type before ``P V`` summed in fp32, with
autocast off inside it (XLA computes it there, not a Pallas kernel).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from ..builder import HEADS
from ..utils.layers import ConvModule
from .base import BaseDecodeHead
from .psp_head import adaptive_avg_pool


@HEADS.register_module()
class ANNHead(BaseDecodeHead):

    def __init__(self, in_channels: Sequence[int] = (1024, 2048),
                 channels: int = 512, num_classes: int = 19,
                 query_scales: Sequence[int] = (1,),
                 key_pool_scales: Sequence[int] = (1, 3, 6, 8),
                 in_index=(2, 3), input_transform='multiple_select',
                 **kwargs):
        super().__init__(list(in_channels), channels, num_classes,
                         in_index=list(in_index),
                         input_transform=input_transform, **kwargs)
        del query_scales
        self.key_pool_scales = tuple(key_pool_scales)
        inter = channels // 2
        self.high_in = ConvModule(in_channels[1], channels, 3, padding=1,
                                  norm_cfg=self.norm_cfg)
        self.q = nn.Conv2d(channels, inter, 1)
        self.k = nn.Linear(channels, inter)
        self.v = nn.Linear(channels, inter)
        self.out_proj = ConvModule(inter, channels, 1, norm_cfg=self.norm_cfg,
                                   act_cfg={'type': 'none'})
        self.bottleneck = ConvModule(channels, channels, 3, padding=1,
                                     norm_cfg=self.norm_cfg)

    def forward(self, inputs):
        high = inputs[self.in_index[1]]
        y = self.high_in(high)
        b, _, h, w = y.shape
        q = self.q(y).flatten(2).transpose(1, 2)            # (B, hw, C/2)
        kv_src = torch.cat([adaptive_avg_pool(y, s).flatten(2)
                            for s in self.key_pool_scales],
                           dim=2).transpose(1, 2)           # (B, 110, C)
        k, v = self.k(kv_src), self.v(kv_src)
        with torch.autocast(y.device.type, enabled=False):
            s = torch.matmul(q.float(), k.float().transpose(1, 2))
            p = torch.softmax(s * q.shape[-1]**-0.5, dim=-1)
            out = torch.matmul(p.to(v.dtype).float(), v.float())
        out = out.transpose(1, 2).reshape(b, -1, h, w).to(y.dtype)
        feats = self.bottleneck(y + self.out_proj(out))
        return self.cls_seg(feats), feats
