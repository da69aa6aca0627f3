"""ISANet's, CCNet's and PSANet's heads on NCHW maps (port of
``pfst_tpu/models/decode_heads/isa_cc_heads.py``): ``_SelfAttention`` and
``ISAHead`` (``:24-92``), ``_criss_cross`` and ``CCHead`` (``:95-167``),
``PSAHead`` (``:170-322``).

Every module has the JAX file's name (``global.{q,k,v}``, ``query_conv``,
``reduce_p``, ``attention_p_mask``, ...), mapped by ``core.convert``, the
classifier ``conv_seg``. The attention products are the JAX file's
``einsum`` formulas with fp32 accumulation, scores and softmax in fp32,
with autocast off inside them (XLA computes them there, not a Pallas
kernel).

* ``ISAHead`` pads the map at its bottom and right to a multiple of
  ``down_factor`` (the padding takes part in the attention, as in the JAX
  file), attends across blocks at each offset (``global``), then within
  each block (``local``), each with a residual, and crops.
* ``CCHead`` applies one criss-cross attention (``query_conv``,
  ``key_conv``, ``value_conv``, the head's ``gamma``) ``recurrence``
  times with its weights shared. The softmax runs over a pixel's row and
  column at once and counts the pixel itself once: its entry in the
  column is masked.
* ``PSAHead``: ``collect``, ``distribute`` and ``bi-direction``; the
  over-complete masks through ``ops.psa_mask``, or with ``compact`` read
  as the dense matrix itself, transposed where the JAX file transposes
  it; ``shrink_factor`` with the JAX file's rounding of odd sizes (both
  odd: rounded up, and the resizes then align corners);
  ``psa_softmax`` over the source positions and
  ``1 / normalization_factor``; the 1x1 ``proj`` on the map grown by a
  zero border, then resized back.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops import resize
from ...ops.psa_mask import psa_mask
from ..builder import HEADS
from ..utils.layers import ConvModule
from .attention_heads import attend, gamma_residual
from .base import BaseDecodeHead


class _SelfAttention(nn.Module):
    """Attention over (B, N, C) rows: q and k C/2 wide, v C wide."""

    def __init__(self, dim: int):
        super().__init__()
        self.q = nn.Linear(dim, dim // 2)
        self.k = nn.Linear(dim, dim // 2)
        self.v = nn.Linear(dim, dim)

    def forward(self, x):
        out = attend(self.q(x), self.k(x), self.v(x), (x.shape[-1] // 2)**-0.5)
        return out.to(x.dtype)


@HEADS.register_module()
class ISAHead(BaseDecodeHead):

    def __init__(self, in_channels: int = 2048, channels: int = 512,
                 num_classes: int = 19, isa_channels: int = 256,
                 down_factor: Sequence[int] = (8, 8), in_index=3, **kwargs):
        super().__init__(in_channels, channels, num_classes,
                         in_index=in_index, **kwargs)
        self.down_factor = tuple(down_factor)
        self.conv_in = ConvModule(in_channels, isa_channels, 3, padding=1,
                                  norm_cfg=self.norm_cfg)
        # ``global`` is a keyword: the JAX file's names through add_module
        self.add_module('global', _SelfAttention(isa_channels))
        self.add_module('local', _SelfAttention(isa_channels))
        self.bottleneck = ConvModule(in_channels + isa_channels, channels, 1,
                                     norm_cfg=self.norm_cfg)

    def forward(self, inputs):
        x = self._transform_inputs(inputs)
        y = self.conv_in(x)
        b, c, h, w = y.shape
        ph, pw = min(self.down_factor[0], h), min(self.down_factor[1], w)
        qh, qw = -(-h // ph), -(-w // pw)
        z = F.pad(y, (0, qw * pw - w, 0, qh * ph - h)).permute(0, 2, 3, 1)
        # long range: across the blocks, at each offset in them
        z = z.reshape(b, qh, ph, qw, pw, c)
        lr = z.permute(0, 2, 4, 1, 3, 5).reshape(b * ph * pw, qh * qw, c)
        lr = lr + getattr(self, 'global')(lr)
        # short range: within each block
        sr = lr.reshape(b, ph, pw, qh, qw, c).permute(
            0, 3, 4, 1, 2, 5).reshape(b * qh * qw, ph * pw, c)
        sr = sr + self.local(sr)
        z = sr.reshape(b, qh, qw, ph, pw, c).permute(
            0, 1, 3, 2, 4, 5).reshape(b, qh * ph, qw * pw, c)
        z = z[:, :h, :w].permute(0, 3, 1, 2)
        feats = self.bottleneck(torch.cat([x, z], dim=1))
        return self.cls_seg(feats), feats


def criss_cross(q, k, v):
    """Row and column attention of each pixel, one softmax over both, the
    pixel itself counted once. q, k (B, Ck, H, W), v (B, C, H, W) ->
    (B, C, H, W) in v's type."""
    h = q.shape[2]
    with torch.autocast(q.device.type, enabled=False):
        qf, kf = q.float(), k.float()
        row = torch.einsum('bchq,bchk->bhqk', qf, kf)         # (B, H, W, W)
        col = torch.einsum('bcqw,bckw->bqwk', qf, kf)         # (B, H, W, H)
        centre = torch.eye(h, dtype=torch.bool, device=q.device)[:, None, :]
        col = col.masked_fill(centre, torch.finfo(torch.float32).min)
        attn = torch.softmax(torch.cat([row, col], dim=-1), dim=-1)
        attn = attn.to(v.dtype).float()
        w = row.shape[-1]
        vf = v.float()
        out = torch.einsum('bhqk,bchk->bchq', attn[..., :w], vf) + \
            torch.einsum('bhwk,bckw->bchw', attn[..., w:], vf)
    return out.to(v.dtype)


@HEADS.register_module()
class CCHead(BaseDecodeHead):

    def __init__(self, in_channels: int = 2048, channels: int = 512,
                 num_classes: int = 19, recurrence: int = 2, in_index=3,
                 **kwargs):
        super().__init__(in_channels, channels, num_classes,
                         in_index=in_index, **kwargs)
        self.recurrence = recurrence
        self.conv_in = ConvModule(in_channels, channels, 3, padding=1,
                                  norm_cfg=self.norm_cfg)
        self.gamma = nn.Parameter(torch.zeros(()))
        self.query_conv = nn.Conv2d(channels, channels // 8, 1)
        self.key_conv = nn.Conv2d(channels, channels // 8, 1)
        self.value_conv = nn.Conv2d(channels, channels, 1)
        self.bottleneck = ConvModule(in_channels + channels, channels, 3,
                                     padding=1, norm_cfg=self.norm_cfg)

    def forward(self, inputs):
        x = self._transform_inputs(inputs)
        y = self.conv_in(x)
        for _ in range(self.recurrence):
            y = gamma_residual(y, self.gamma, criss_cross(
                self.query_conv(y), self.key_conv(y), self.value_conv(y)))
        feats = self.bottleneck(torch.cat([x, y], dim=1))
        return self.cls_seg(feats), feats


@HEADS.register_module()
class PSAHead(BaseDecodeHead):

    def __init__(self, in_channels: int = 2048, channels: int = 512,
                 num_classes: int = 19, mask_size: Sequence[int] = (97, 97),
                 psa_type: str = 'bi-direction', compact: bool = False,
                 shrink_factor: int = 2, normalization_factor: float = 1.0,
                 psa_softmax: bool = True, in_index=3, **kwargs):
        super().__init__(in_channels, channels, num_classes,
                         in_index=in_index, **kwargs)
        if psa_type not in ('collect', 'distribute', 'bi-direction'):
            raise ValueError(f'psa_type {psa_type}')
        self.mask_size = tuple(mask_size)
        self.psa_type, self.compact = psa_type, compact
        self.shrink_factor = shrink_factor
        self.normalization_factor = normalization_factor
        self.psa_softmax = psa_softmax
        norm, n_mask = self.norm_cfg, self.mask_size[0] * self.mask_size[1]
        branches = ['reduce', 'reduce_p'] if psa_type == 'bi-direction' \
            else ['reduce']
        for reduce, attn in zip(branches, ('attention', 'attention_p')):
            self.add_module(reduce, ConvModule(in_channels, channels, 1,
                                               norm_cfg=norm))
            self.add_module(f'{attn}_conv', ConvModule(channels, channels, 1,
                                                       norm_cfg=norm))
            self.add_module(f'{attn}_mask', nn.Conv2d(channels, n_mask, 1,
                                                      bias=False))
        self.proj = ConvModule(len(branches) * channels, in_channels, 1,
                               norm_cfg=norm)
        self.bottleneck = ConvModule(2 * in_channels, channels, 3, padding=1,
                                     norm_cfg=norm)

    def _shrink(self, y):
        """The map resized by ``shrink_factor``: where both sides are not
        multiples of it, to the sizes rounded up, corners aligned."""
        h, w = y.shape[2:]
        sf = self.shrink_factor
        if sf == 1:
            return y, self.align_corners
        if h % sf and w % sf:
            size, ac = ((h - 1) // sf + 1, (w - 1) // sf + 1), True
        else:
            size, ac = (h // sf, w // sf), False
        return resize(y, size=size, mode='bilinear', align_corners=ac), ac

    def _to_attn(self, raw, kind):
        """(B, mask channels, h, w) -> (B, hw, hw) laid out [k, q]. The
        compact masks are the matrix [position, channel]; the JAX file
        transposes it for a single 'distribute' and for the collecting
        half of 'bi-direction'."""
        if not self.compact:
            return psa_mask(raw, self.mask_size, kind)
        channel_major = self.psa_type == 'distribute' or (
            self.psa_type == 'bi-direction' and kind == 'collect')
        flat = raw.flatten(2)                          # [channel, position]
        return flat if channel_major else flat.transpose(1, 2)

    def _aggregate(self, y, attn):
        """``out[q] = sum_k attn[k, q] y[k]``, softmax over k first, then
        ``1 / normalization_factor``."""
        b, c, h, w = y.shape
        yf = y.flatten(2)
        with torch.autocast(y.device.type, enabled=False):
            if self.psa_softmax:
                attn = torch.softmax(attn.float(), dim=1)
            out = torch.matmul(yf.float(), attn.to(yf.dtype).float())
        return out.to(y.dtype).reshape(b, c, h, w) * (
            1.0 / self.normalization_factor)

    def _branch(self, x, reduce, attn, kind):
        y, ac = self._shrink(getattr(self, reduce)(x))
        raw = getattr(self, f'{attn}_mask')(getattr(self, f'{attn}_conv')(y))
        return self._aggregate(y, self._to_attn(raw, kind)), ac

    def forward(self, inputs):
        x = self._transform_inputs(inputs)
        if self.psa_type == 'bi-direction':
            o_col, ac = self._branch(x, 'reduce', 'attention', 'collect')
            o_dis, _ = self._branch(x, 'reduce_p', 'attention_p',
                                    'distribute')
            out = torch.cat([o_col, o_dis], dim=1)
        else:
            out, ac = self._branch(x, 'reduce', 'attention', self.psa_type)
        # the 1x1 proj declared with padding 1 grows the map by a zero
        # border, as in the JAX file
        out = self.proj(F.pad(out, (1, 1, 1, 1)))
        out = resize(out, size=x.shape[2:], mode='bilinear', align_corners=ac)
        feats = self.bottleneck(torch.cat([x, out], dim=1))
        return self.cls_seg(feats), feats
