"""FCN head, the auxiliary head of the PFST configs (port of
``FCNHead`` in ``pfst_tpu/models/decode_heads/fcn_head.py``).

``num_convs`` 3x3 conv+BN+ReLU blocks (``convs.i``), optional input
concat (``conv_cat``), then the dropout + ``conv_seg`` classifier.
Serving does not run it; it is built so that checkpoints load.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ..builder import HEADS
from ..utils.layers import ConvModule
from .base import BaseDecodeHead


@HEADS.register_module()
class FCNHead(BaseDecodeHead):

    def __init__(self, in_channels: int = 1024, channels: int = 256,
                 num_classes: int = 19, num_convs: int = 2,
                 kernel_size: int = 3, concat_input: bool = True,
                 dilation: int = 1, in_index=2, **kwargs):
        super().__init__(in_channels, channels, num_classes,
                         in_index=in_index, **kwargs)
        cfgs = dict(norm_cfg=self.norm_cfg, act_cfg=self.act_cfg)
        pad = (kernel_size // 2) * dilation
        self.convs = nn.Sequential(*[
            ConvModule(in_channels if i == 0 else channels, channels,
                       kernel_size, padding=pad, dilation=dilation, **cfgs)
            for i in range(num_convs)])
        self.concat_input = concat_input
        if concat_input:
            self.conv_cat = ConvModule(
                in_channels + (channels if num_convs else in_channels),
                channels, kernel_size, padding=kernel_size // 2, **cfgs)

    def forward(self, inputs):
        x = self._transform_inputs(inputs)
        feats = self.convs(x)
        if self.concat_input:
            feats = self.conv_cat(torch.cat([x, feats], dim=1))
        return self.cls_seg(feats), feats
