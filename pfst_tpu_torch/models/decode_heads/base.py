"""Decode-head shared machinery (port of
``pfst_tpu/models/decode_heads/base.py``).

``BaseDecodeHead`` holds what the JAX file's ``ClsSeg`` does (dropout +
1x1 classifier, ``decode_head.py:242-247``) as mmseg's ``dropout`` and
``conv_seg`` attributes, so the classifier's keys are
``decode_head.conv_seg.*``. Heads return ``(seg_logits,
decoded_features)``; losses come with the training path.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn as nn

from ...ops import resize


def transform_inputs(inputs, in_index, input_transform: Optional[str],
                     align_corners: bool):
    """Select/concat multi-level features (``decode_head.py:155-180``)."""
    if input_transform in ('resize_concat', 'multiple_select') and \
            isinstance(in_index, int):
        in_index = [in_index]  # tolerate scalar in_index in configs
    if input_transform == 'resize_concat':
        xs = [inputs[i] for i in in_index]
        ups = [resize(x, size=xs[0].shape[2:], mode='bilinear',
                      align_corners=align_corners) for x in xs]
        return torch.cat(ups, dim=1)
    if input_transform == 'multiple_select':
        return [inputs[i] for i in in_index]
    return inputs[in_index]


class Upsample(nn.Module):
    """Bilinear resize by an integer factor, a module so that it can sit
    in a ``Sequential`` (mmseg's ``Upsample``; no parameters)."""

    def __init__(self, scale: int, align_corners: bool):
        super().__init__()
        self.scale = scale
        self.align_corners = align_corners

    def forward(self, x):
        return resize(x, scale_factor=self.scale, mode='bilinear',
                      align_corners=self.align_corners)


class BaseDecodeHead(nn.Module):
    """Common head kwargs (mirroring mmseg's ``BaseDecodeHead``) and the
    dropout + ``conv_seg`` classifier."""

    def __init__(self,
                 in_channels: Union[int, Sequence[int]],
                 channels: int,
                 num_classes: int,
                 dropout_ratio: float = 0.1,
                 in_index: Union[int, Sequence[int]] = -1,
                 input_transform: Optional[str] = None,
                 align_corners: bool = False,
                 norm_cfg: Optional[dict] = None,
                 act_cfg: Optional[dict] = None,
                 ignore_index: int = 255,
                 loss_decode=None,
                 sampler: Optional[dict] = None):
        super().__init__()
        self.in_channels = in_channels
        self.channels = channels
        self.num_classes = num_classes
        self.in_index = in_index
        self.input_transform = input_transform
        self.align_corners = align_corners
        self.norm_cfg = norm_cfg
        self.act_cfg = act_cfg
        self.ignore_index = ignore_index
        self.loss_decode = loss_decode
        self.sampler = sampler
        # the JAX file drops elements, not channels (flax nn.Dropout)
        self.dropout = nn.Dropout(dropout_ratio) if dropout_ratio > 0 \
            else None
        self.conv_seg = nn.Conv2d(channels, num_classes, 1)

    def _transform_inputs(self, inputs):
        return transform_inputs(inputs, self.in_index, self.input_transform,
                                self.align_corners)

    def cls_seg(self, feat):
        if self.dropout is not None:
            feat = self.dropout(feat)
        return self.conv_seg(feat)
