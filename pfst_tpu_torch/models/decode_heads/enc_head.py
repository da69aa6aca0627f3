"""EncNet's head on NCHW maps (port of
``pfst_tpu/models/decode_heads/enc_head.py``).

The deepest selected level through a 3x3 ConvModule (``bottleneck``),
its pixels encoded over the codewords (``encoding``, ``ops.encoding``),
the ReLU of the mean over the codes gating the channels through a
sigmoid of ``fc``, then the classifier ``conv_seg``. ``se_layer`` gives
the image-level class-presence logits of the SE loss, returned only when
asked for (``with_se``); ``se_onehot_labels`` makes its targets. The
other selected levels are read and unused and ``add_lateral`` is
accepted and unused, as in the JAX file.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.encoding import Encoding
from ..builder import HEADS
from ..utils.layers import ConvModule
from .attention_heads import tokens
from .base import BaseDecodeHead


@HEADS.register_module()
class EncHead(BaseDecodeHead):

    def __init__(self, in_channels: Sequence[int] = (512, 1024, 2048),
                 channels: int = 512, num_classes: int = 19,
                 num_codes: int = 32, use_se_loss: bool = True,
                 add_lateral: bool = False, in_index=(1, 2, 3),
                 input_transform='multiple_select',
                 loss_se_decode: Optional[dict] = None, **kwargs):
        super().__init__(list(in_channels), channels, num_classes,
                         in_index=list(in_index),
                         input_transform=input_transform, **kwargs)
        del add_lateral
        self.use_se_loss = use_se_loss
        self.loss_se_decode = loss_se_decode
        self.bottleneck = ConvModule(in_channels[-1], channels, 3, padding=1,
                                     norm_cfg=self.norm_cfg)
        self.encoding = Encoding(channels, num_codes)
        self.fc = nn.Linear(channels, channels)
        self.se_layer = nn.Linear(channels, num_classes)

    def forward(self, inputs, with_se: bool = False):
        x = self.bottleneck(self._transform_inputs(inputs)[-1])
        enc = F.relu(self.encoding(tokens(x)).mean(1))        # (B, C)
        y = x * torch.sigmoid(self.fc(enc))[:, :, None, None]
        logits = self.cls_seg(y)
        if with_se:
            return logits, y, self.se_layer(enc)
        return logits, y

    def se_onehot_labels(self, gt: torch.Tensor) -> torch.Tensor:
        """(B, H, W) labels -> (B, num_classes) fp32 class presence; the
        ignore index lies outside the classes."""
        classes = torch.arange(self.num_classes, device=gt.device)
        return (gt.flatten(1)[:, :, None] == classes).any(1).float()
