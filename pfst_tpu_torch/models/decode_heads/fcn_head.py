"""FCN head, the auxiliary head of the PFST configs, its
depthwise-separable variant, and the Semantic-FPN head (port of
``FCNHead``, ``DepthwiseSeparableFCNHead`` and ``FPNHead`` in
``pfst_tpu/models/decode_heads/fcn_head.py``).

``FCNHead``: ``num_convs`` 3x3 conv+BN+ReLU blocks (``convs.i``),
optional input concat (``conv_cat``), then the dropout + ``conv_seg``
classifier; with no convs and no concat the classifier takes the input
at its own width, as the JAX file's infers it.

``FPNHead`` (``:111-156``): level i runs ``max(1, log2(stride_i /
stride_0))`` 3x3 ConvModules, each followed by a bilinear x2 but on
level 0; the levels are summed and classified. mmseg's names:
``scale_heads.{i}.{k}``, the convs and (parameterless) upsamplings of
level i in turn.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn

from ..builder import HEADS
from ..utils.layers import ConvModule, DepthwiseSeparableConvModule
from .base import BaseDecodeHead, Upsample


@HEADS.register_module()
class FCNHead(BaseDecodeHead):

    conv_module = ConvModule

    def __init__(self, in_channels: int = 1024, channels: int = 256,
                 num_classes: int = 19, num_convs: int = 2,
                 kernel_size: int = 3, concat_input: bool = True,
                 dilation: int = 1, in_index=2, **kwargs):
        super().__init__(in_channels, channels, num_classes,
                         in_index=in_index, **kwargs)
        cfgs = dict(norm_cfg=self.norm_cfg, act_cfg=self.act_cfg)
        pad = (kernel_size // 2) * dilation
        self.convs = nn.Sequential(*[
            self.conv_module(in_channels if i == 0 else channels, channels,
                             kernel_size, padding=pad, dilation=dilation,
                             **cfgs)
            for i in range(num_convs)])
        self.concat_input = concat_input
        if concat_input:
            self.conv_cat = self.conv_module(
                in_channels + (channels if num_convs else in_channels),
                channels, kernel_size, padding=kernel_size // 2, **cfgs)
        elif not num_convs:
            # the JAX file classifies the input itself, at its width
            self.conv_seg = nn.Conv2d(in_channels, num_classes, 1)

    def forward(self, inputs):
        x = self._transform_inputs(inputs)
        feats = self.convs(x)
        if self.concat_input:
            feats = self.conv_cat(torch.cat([x, feats], dim=1))
        return self.cls_seg(feats), feats


@HEADS.register_module()
class DepthwiseSeparableFCNHead(FCNHead):
    """``FCNHead`` with ``DepthwiseSeparableConvModule``s
    (``fcn_head.py:65-108``, mmseg's ``sep_fcn_head.py``; the Fast-SCNN
    head): ``convs.{i}`` (the JAX file's ``conv{i}``) and ``conv_cat``."""

    conv_module = DepthwiseSeparableConvModule

    def __init__(self, in_channels: int = 128, channels: int = 128,
                 num_classes: int = 19, num_convs: int = 1,
                 concat_input: bool = False, in_index=-1, **kwargs):
        super().__init__(in_channels, channels, num_classes, num_convs,
                         concat_input=concat_input, in_index=in_index,
                         **kwargs)


@HEADS.register_module()
class FPNHead(BaseDecodeHead):

    def __init__(self, in_channels: Sequence[int] = (256, 256, 256, 256),
                 channels: int = 128, num_classes: int = 19,
                 feature_strides: Sequence[int] = (4, 8, 16, 32),
                 in_index=(0, 1, 2, 3), input_transform='multiple_select',
                 **kwargs):
        super().__init__(list(in_channels), channels, num_classes,
                         in_index=list(in_index),
                         input_transform=input_transform or
                         'multiple_select', **kwargs)
        base = feature_strides[0]
        self.scale_heads = nn.ModuleList()
        for c, stride in zip(in_channels, feature_strides):
            n_up = 1 if stride == base else max(
                1, int(math.log2(stride // base)))
            layers = []
            for j in range(n_up):
                layers.append(ConvModule(c if j == 0 else channels, channels,
                                         3, padding=1,
                                         norm_cfg=self.norm_cfg))
                if stride != base:
                    layers.append(Upsample(2, self.align_corners))
            self.scale_heads.append(nn.Sequential(*layers))

    def forward(self, inputs):
        xs = self._transform_inputs(inputs)
        out = None
        for head, x in zip(self.scale_heads, xs):
            x = head(x)
            out = x if out is None else out + x
        return self.cls_seg(out), out
