"""UNet backbone on NCHW tensors (port of
``pfst_tpu/models/backbones/unet.py``).

Encoder stages of ``BasicConvBlock`` (max-pooled 2x2 between them where
``downsamples`` says), then a decoder that, for each skip from the
deepest up, resizes bilinearly to the skip's size, projects with the 1x1
``ConvModule`` ``up{i}``, concatenates ``[skip, y]`` and runs
``dec{i}``. This follows the JAX file where it departs from mmseg: no
``InterpConv`` (``upsample_cfg`` and ``act_cfg`` are accepted and unused),
and no check that the input divides by the total stride. Returns the
deepest encoder map and then each decoder map, deepest first. Module
names are the JAX file's (``enc{i}.conv{j}``, ``up{i}``,
``dec{i}.conv{j}``), mapped by ``core.convert``'s ``cnn`` family.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops import resize
from ..builder import BACKBONES
from ..utils.layers import ConvModule, NormEvalModule


class BasicConvBlock(nn.Sequential):
    """``num_convs`` 3x3 ``ConvModule``s ``conv{i}``; the first carries the
    stride, the others the dilation."""

    def __init__(self, in_channels: int, out_channels: int,
                 num_convs: int = 2, stride: int = 1, dilation: int = 1,
                 norm_cfg: Optional[dict] = None):
        super().__init__()
        for i in range(num_convs):
            self.add_module(f'conv{i}', ConvModule(
                in_channels if i == 0 else out_channels, out_channels, 3,
                stride=stride if i == 0 else 1,
                padding=1 if i == 0 else dilation,
                dilation=1 if i == 0 else dilation, norm_cfg=norm_cfg))


@BACKBONES.register_module()
class UNet(NormEvalModule):

    key_family = 'cnn'      # core.convert's key map

    def __init__(self,
                 in_channels: int = 3,
                 base_channels: int = 64,
                 num_stages: int = 5,
                 strides: Sequence[int] = (1, 1, 1, 1, 1),
                 enc_num_convs: Sequence[int] = (2, 2, 2, 2, 2),
                 dec_num_convs: Sequence[int] = (2, 2, 2, 2),
                 downsamples: Sequence[bool] = (True, True, True, True),
                 enc_dilations: Sequence[int] = (1, 1, 1, 1, 1),
                 dec_dilations: Sequence[int] = (1, 1, 1, 1),
                 norm_cfg: Optional[dict] = None,
                 act_cfg: Optional[dict] = None,
                 upsample_cfg: Optional[dict] = None,
                 norm_eval: bool = False,
                 pretrained: Optional[str] = None,
                 init_cfg: Optional[dict] = None):
        super().__init__()
        del act_cfg, upsample_cfg, pretrained, init_cfg
        self.num_stages = num_stages
        self.downsamples = tuple(downsamples)
        self.norm_eval = norm_eval
        chans = [base_channels * 2**i for i in range(num_stages)]
        cin = in_channels
        for i, ch in enumerate(chans):
            self.add_module(f'enc{i}', BasicConvBlock(
                cin, ch, enc_num_convs[i], strides[i], enc_dilations[i],
                norm_cfg))
            cin = ch
        for i in range(num_stages - 2, -1, -1):
            self.add_module(f'up{i}', ConvModule(chans[i + 1], chans[i], 1,
                                                 norm_cfg=norm_cfg))
            self.add_module(f'dec{i}', BasicConvBlock(
                2 * chans[i], chans[i], dec_num_convs[i],
                dilation=dec_dilations[i], norm_cfg=norm_cfg))
        self.feature_channels = tuple(chans[::-1])

    def forward(self, x):
        enc = []
        for i in range(self.num_stages):
            if i > 0 and self.downsamples[i - 1]:
                x = F.max_pool2d(x, 2, 2)
            x = getattr(self, f'enc{i}')(x)
            enc.append(x)
        outs, y = [enc[-1]], enc[-1]
        for i in range(self.num_stages - 2, -1, -1):
            skip = enc[i]
            y = resize(y, size=skip.shape[2:], mode='bilinear',
                       align_corners=False)
            y = getattr(self, f'up{i}')(y)
            y = getattr(self, f'dec{i}')(torch.cat([skip, y], dim=1))
            outs.append(y)
        return tuple(outs)
