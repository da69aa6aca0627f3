"""DANet's, the non-local and GCNet's heads on NCHW maps (port of
``pfst_tpu/models/decode_heads/attention_heads.py``): ``PositionAttention``,
``ChannelAttention`` and ``DAHead`` (``:21-123``), ``NLHead``
(``:126-180``) and ``GCHead`` (``:183-234``).

Every module has the JAX file's name (``pam_in``, ``pam.{q,k,v,gamma}``,
``theta``, ``context_mask``, ``transform_ln``, ...), mapped by
``core.convert``; the classifier is ``conv_seg``, and DANet's branch
classifiers ``pam_cls.conv_seg`` and ``cam_cls.conv_seg``. The attention
products are the JAX file's ``einsum``s with fp32 accumulation: scores
and softmax in fp32, the probabilities rounded to the values' type before
``P V`` summed in fp32, with autocast off inside them (XLA computes them
there, not a Pallas kernel). A learned ``gamma`` scales a residual as the
JAX file's type promotion does: the fp32 scalar times the branch, added in
fp32.

* ``DAHead`` returns ``(logits, feats, pam_logits, cam_logits)`` and
  declares its branch losses (``branch_loss_names``), which the
  segmentor's ``forward_train`` takes; inference reads the first two.
* ``GCHead``'s ``transform_ln`` is flax's LayerNorm over the channels at
  eps 1e-6, where mmseg's ContextBlock normalizes [C, 1, 1] at 1e-5; the
  context is always added (``fusion_types`` is read and unused), as in
  the JAX file.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..builder import HEADS
from ..utils.layers import ConvModule
from .base import BaseDecodeHead

_NO_ACT = {'type': 'none'}


def attend(q, k, v, scale=None):
    """``softmax(q k^T * scale) v`` over (B, N, d) rows, the JAX file's
    way: fp32 scores and softmax, P rounded to v's type, ``P V`` summed in
    fp32; returns fp32."""
    with torch.autocast(q.device.type, enabled=False):
        s = torch.matmul(q.float(), k.float().transpose(1, 2))
        p = torch.softmax(s if scale is None else s * scale, dim=-1)
        return torch.matmul(p.to(v.dtype).float(), v.float())


def gamma_residual(x, gamma, out):
    """``x + gamma * out`` with ``out`` first in x's type, fp32 as the
    JAX file's promotion of the fp32 ``gamma`` makes it."""
    return x.float() + gamma * out.to(x.dtype).float()


def tokens(x):
    """(B, C, H, W) -> (B, HW, C)."""
    return x.flatten(2).transpose(1, 2)


def as_map(t, h, w):
    """(B, HW, C) -> (B, C, H, W)."""
    return t.transpose(1, 2).reshape(t.shape[0], -1, h, w)


class ClsSeg(nn.Module):
    """Dropout and the 1x1 classifier ``conv_seg`` (the JAX file's
    ``ClsSeg``), for a head's extra classifiers."""

    def __init__(self, channels: int, num_classes: int, dropout_ratio: float):
        super().__init__()
        self.dropout = nn.Dropout(dropout_ratio) if dropout_ratio > 0 \
            else None
        self.conv_seg = nn.Conv2d(channels, num_classes, 1)

    def forward(self, x):
        return self.conv_seg(x if self.dropout is None else self.dropout(x))


class PositionAttention(nn.Module):
    """DANet's PAM: attention over positions, q and k C/8 wide."""

    def __init__(self, channels: int):
        super().__init__()
        self.q = nn.Conv2d(channels, channels // 8, 1)
        self.k = nn.Conv2d(channels, channels // 8, 1)
        self.v = nn.Conv2d(channels, channels, 1)
        self.gamma = nn.Parameter(torch.zeros(()))

    def forward(self, x):
        h, w = x.shape[2:]
        out = attend(tokens(self.q(x)), tokens(self.k(x)), tokens(self.v(x)))
        return gamma_residual(x, self.gamma, as_map(out, h, w))


class ChannelAttention(nn.Module):
    """DANet's CAM: attention over channels, on ``max - energy``."""

    def __init__(self):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(()))

    def forward(self, x):
        b, c, h, w = x.shape
        xf = x.flatten(2)                                     # (B, C, HW)
        with torch.autocast(x.device.type, enabled=False):
            energy = torch.matmul(xf.float(), xf.float().transpose(1, 2))
            energy = energy.amax(-1, keepdim=True) - energy
            p = torch.softmax(energy, dim=-1)
            out = torch.matmul(p.to(xf.dtype).float(), xf.float())
        return gamma_residual(x, self.gamma, out.reshape(b, c, h, w))


@HEADS.register_module()
class DAHead(BaseDecodeHead):

    # the segmentor's forward_train takes a loss of each extra output
    branch_loss_names = ('pam', 'cam')
    primary_loss_name = 'pam_cam'

    def __init__(self, in_channels: int = 2048, channels: int = 512,
                 num_classes: int = 19, pam_channels: int = 64,
                 in_index=3, **kwargs):
        super().__init__(in_channels, channels, num_classes,
                         in_index=in_index, **kwargs)
        del pam_channels
        norm, drop = self.norm_cfg, kwargs.get('dropout_ratio', 0.1)
        for branch in ('pam', 'cam'):
            self.add_module(f'{branch}_in', ConvModule(
                in_channels, channels, 3, padding=1, norm_cfg=norm))
            self.add_module(branch, PositionAttention(channels)
                            if branch == 'pam' else ChannelAttention())
            self.add_module(f'{branch}_out', ConvModule(
                channels, channels, 3, padding=1, norm_cfg=norm))
            self.add_module(f'{branch}_cls', ClsSeg(channels, num_classes,
                                                    drop))

    def forward(self, inputs):
        x = self._transform_inputs(inputs)
        pam = self.pam_out(self.pam(self.pam_in(x)))
        cam = self.cam_out(self.cam(self.cam_in(x)))
        feats = pam + cam
        return self.cls_seg(feats), feats, self.pam_cls(pam), \
            self.cam_cls(cam)


@HEADS.register_module()
class NLHead(BaseDecodeHead):

    def __init__(self, in_channels: int = 2048, channels: int = 512,
                 num_classes: int = 19, reduction: int = 2,
                 use_scale: bool = True, mode: str = 'embedded_gaussian',
                 in_index=3, **kwargs):
        super().__init__(in_channels, channels, num_classes,
                         in_index=in_index, **kwargs)
        del mode
        self.use_scale = use_scale
        inter = max(channels // reduction, 1)
        self.conv_in = ConvModule(in_channels, channels, 3, padding=1,
                                  norm_cfg=self.norm_cfg)
        for name in ('theta', 'phi', 'g'):
            self.add_module(name, nn.Conv2d(channels, inter, 1))
        self.conv_out_nl = ConvModule(inter, channels, 1,
                                      norm_cfg=self.norm_cfg, act_cfg=_NO_ACT)
        self.bottleneck = ConvModule(in_channels + channels, channels, 3,
                                     padding=1, norm_cfg=self.norm_cfg)

    def forward(self, inputs):
        x = self._transform_inputs(inputs)
        y = self.conv_in(x)
        h, w = y.shape[2:]
        g = tokens(self.g(y))
        scale = g.shape[-1]**-0.5 if self.use_scale else None
        out = attend(tokens(self.theta(y)), tokens(self.phi(y)), g, scale)
        y = y + self.conv_out_nl(as_map(out, h, w).to(y.dtype))
        feats = self.bottleneck(torch.cat([x, y], dim=1))
        return self.cls_seg(feats), feats


@HEADS.register_module()
class GCHead(BaseDecodeHead):

    def __init__(self, in_channels: int = 2048, channels: int = 512,
                 num_classes: int = 19, ratio: float = 0.25,
                 pooling_type: str = 'att',
                 fusion_types: Sequence[str] = ('channel_add',),
                 in_index=3, **kwargs):
        super().__init__(in_channels, channels, num_classes,
                         in_index=in_index, **kwargs)
        del fusion_types
        self.pooling_type = pooling_type
        hidden = max(int(channels * ratio), 1)
        self.conv_in = ConvModule(in_channels, channels, 3, padding=1,
                                  norm_cfg=self.norm_cfg)
        if pooling_type == 'att':
            self.context_mask = nn.Conv2d(channels, 1, 1)
        self.transform1 = nn.Conv2d(channels, hidden, 1)
        self.transform_ln = nn.LayerNorm(hidden, eps=1e-6)
        self.transform2 = nn.Conv2d(hidden, channels, 1)
        self.bottleneck = ConvModule(in_channels + channels, channels, 3,
                                     padding=1, norm_cfg=self.norm_cfg)

    def forward(self, inputs):
        x = self._transform_inputs(inputs)
        y = self.conv_in(x)
        if self.pooling_type == 'att':
            mask = torch.softmax(self.context_mask(y).flatten(2).float(),
                                 dim=-1)                      # (B, 1, HW)
            with torch.autocast(y.device.type, enabled=False):
                context = torch.matmul(y.flatten(2).float(),
                                       mask.transpose(1, 2))  # (B, C, 1)
            context = context.to(y.dtype)[..., None]
        else:
            context = y.mean((2, 3), keepdim=True)
        t = self.transform1(context).flatten(1)
        t = F.relu(self.transform_ln(t))[:, :, None, None]
        y = y + self.transform2(t)
        feats = self.bottleneck(torch.cat([x, y], dim=1))
        return self.cls_seg(feats), feats
