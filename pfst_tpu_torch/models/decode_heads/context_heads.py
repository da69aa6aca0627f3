"""Context heads on NCHW maps (port of
``pfst_tpu/models/decode_heads/context_heads.py``): ``OCRHead``
(``:22-86``), ``DNLHead`` (``:89-148``), ``ANNHead`` (``:151-195``),
``APCHead`` and ``DMHead`` (``:198-272``) and ``EMAHead`` (``:275-350``).

Every module has the JAX file's name, mapped by ``core.convert``, the
classifier ``conv_seg``. The attention products are the JAX file's
``einsum`` formulas with fp32 accumulation, scores and softmax in fp32,
with autocast off inside them (XLA computes them there, not a Pallas
kernel).

* ``DNLHead``: theta and phi whitened by their means over the positions,
  the pairwise softmax at ``temperature``, and the softmaxed unary map
  (``unary``) added to every query's row.
* ``OCRHead``: the JAX file's object-contextual head, not mmseg's
  ``ObjectAttentionBlock``: a 3x3 ConvModule (``bottleneck``); the
  previous stage's logits (``prev_logits``, not detached: the loss
  reaches the stage before through them), softmaxed over the positions,
  weight the class means of the features; a 1x1 conv (``query``) and two
  Dense layers over the class vectors (``key``, ``value``) attend at
  ``ocr_channels ** -0.5``; a 1x1 ConvModule (``fuse``) over ``[feats,
  ocr]`` and the classifier. Standing alone (``prev_stage=False``) the
  head makes its own prior with a 1x1 conv (``soft_regions``); as a later
  stage of ``CascadeEncoderDecoder`` it has none, as the JAX tree has
  none there.
* ``ANNHead``: the JAX file's single asymmetric attention, not mmseg's
  AFNB and APNB: the deepest level through a 3x3 ConvModule
  (``high_in``); queries from a 1x1 conv (``q``) at every pixel, keys and
  values (``k``, ``v``) from the 1 + 9 + 36 + 64 adaptive average pools
  of the same map; their attention, a 1x1 ConvModule without activation
  (``out_proj``), a residual sum and a 3x3 ConvModule (``bottleneck``).
  The first selected level is read and unused, as in the JAX file.
* ``APCHead``: the JAX file's affinity of each pixel (``query{i}``) to the
  s^2 cells of each adaptive pool (``pool_proj{i}``), not mmseg's ACM;
  ``DMHead`` is the same head under another name, not mmseg's dynamic
  filters.
* ``EMAHead``: ``bases`` is a buffer (the JAX file's ``batch_stats``),
  left out of the optimizer and saved with the state dict. The EM
  iterations run without gradient on the detached features; in training
  the buffer takes ``(1 - momentum) bases + momentum normalize(mean_b
  mu)``.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..builder import HEADS
from ..utils.layers import ConvModule
from .attention_heads import as_map, attend, tokens
from .base import BaseDecodeHead
from .psp_head import adaptive_avg_pool

_NO_ACT = {'type': 'none'}


@HEADS.register_module()
class OCRHead(BaseDecodeHead):

    def __init__(self, in_channels: int = 2048, channels: int = 512,
                 num_classes: int = 19, ocr_channels: int = 256,
                 scale: int = 1, in_index=3, prev_stage: bool = False,
                 **kwargs):
        super().__init__(in_channels, channels, num_classes,
                         in_index=in_index, **kwargs)
        del scale
        self.ocr_channels = ocr_channels
        self.bottleneck = ConvModule(in_channels, channels, 3, padding=1,
                                     norm_cfg=self.norm_cfg)
        if not prev_stage:
            self.soft_regions = nn.Conv2d(channels, num_classes, 1)
        self.query = nn.Conv2d(channels, ocr_channels, 1)
        self.key = nn.Linear(channels, ocr_channels)
        self.value = nn.Linear(channels, ocr_channels)
        self.fuse = ConvModule(channels + ocr_channels, channels, 1,
                               norm_cfg=self.norm_cfg)

    def forward(self, inputs, prev_logits=None):
        feats = self.bottleneck(self._transform_inputs(inputs))
        if prev_logits is None:
            prev_logits = self.soft_regions(feats)
        h, w = feats.shape[2:]
        with torch.autocast(feats.device.type, enabled=False):
            probs = torch.softmax(prev_logits.float().flatten(2), dim=2)
            context = torch.matmul(probs, tokens(feats).float())  # (B, K, C)
        context = context.to(feats.dtype)
        ocr = attend(tokens(self.query(feats)), self.key(context),
                     self.value(context), self.ocr_channels**-0.5)
        out = self.fuse(torch.cat([feats, as_map(ocr, h, w).to(feats.dtype)],
                                  dim=1))
        return self.cls_seg(out), out


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
        h, w = y.shape[2:]
        q = tokens(self.q(y))                               # (B, hw, C/2)
        kv_src = torch.cat([adaptive_avg_pool(y, s).flatten(2)
                            for s in self.key_pool_scales],
                           dim=2).transpose(1, 2)           # (B, 110, C)
        out = attend(q, self.k(kv_src), self.v(kv_src), q.shape[-1]**-0.5)
        out = as_map(out, h, w).to(y.dtype)
        feats = self.bottleneck(y + self.out_proj(out))
        return self.cls_seg(feats), feats


@HEADS.register_module()
class DNLHead(BaseDecodeHead):

    def __init__(self, in_channels: int = 2048, channels: int = 512,
                 num_classes: int = 19, reduction: int = 2,
                 temperature: float = 0.05, in_index=3, **kwargs):
        super().__init__(in_channels, channels, num_classes,
                         in_index=in_index, **kwargs)
        self.temperature = temperature
        inter = max(channels // reduction, 1)
        self.conv_in = ConvModule(in_channels, channels, 3, padding=1,
                                  norm_cfg=self.norm_cfg)
        for name in ('theta', 'phi', 'g'):
            self.add_module(name, nn.Conv2d(channels, inter, 1))
        self.unary = nn.Conv2d(channels, 1, 1)
        self.conv_out_nl = ConvModule(inter, channels, 1,
                                      norm_cfg=self.norm_cfg, act_cfg=_NO_ACT)
        self.bottleneck = ConvModule(in_channels + channels, channels, 3,
                                     padding=1, norm_cfg=self.norm_cfg)

    def forward(self, inputs):
        x = self._transform_inputs(inputs)
        y = self.conv_in(x)
        h, w = y.shape[2:]
        theta, phi = tokens(self.theta(y)), tokens(self.phi(y))
        g, unary = tokens(self.g(y)), self.unary(y).flatten(2)
        with torch.autocast(y.device.type, enabled=False):
            theta = theta.float() - theta.float().mean(1, keepdim=True)
            phi = phi.float() - phi.float().mean(1, keepdim=True)
            pair = torch.softmax(torch.matmul(theta, phi.transpose(1, 2))
                                 / self.temperature, dim=-1)
            attn = pair + torch.softmax(unary.float(), dim=-1)  # (B, 1, HW)
            out = torch.matmul(attn.to(g.dtype).float(), g.float())
        y = y + self.conv_out_nl(as_map(out, h, w).to(y.dtype))
        feats = self.bottleneck(torch.cat([x, y], dim=1))
        return self.cls_seg(feats), feats


@HEADS.register_module()
class APCHead(BaseDecodeHead):

    def __init__(self, in_channels: int = 2048, channels: int = 512,
                 num_classes: int = 19,
                 pool_scales: Sequence[int] = (1, 2, 3, 6),
                 fusion: bool = True, in_index=3, **kwargs):
        super().__init__(in_channels, channels, num_classes,
                         in_index=in_index, **kwargs)
        del fusion
        self.pool_scales = tuple(pool_scales)
        for i in range(len(self.pool_scales)):
            self.add_module(f'pool_proj{i}', ConvModule(
                in_channels, channels, 1, norm_cfg=self.norm_cfg))
            self.add_module(f'query{i}', ConvModule(
                in_channels, channels, 1, norm_cfg=self.norm_cfg))
        self.bottleneck = ConvModule(
            in_channels + len(self.pool_scales) * channels, channels, 3,
            padding=1, norm_cfg=self.norm_cfg)

    def forward(self, inputs):
        x = self._transform_inputs(inputs)
        h, w = x.shape[2:]
        outs = [x]
        for i, s in enumerate(self.pool_scales):
            kf = tokens(getattr(self, f'pool_proj{i}')(
                adaptive_avg_pool(x, s)))                    # (B, s^2, C)
            out = attend(tokens(getattr(self, f'query{i}')(x)), kf, kf)
            outs.append(as_map(out, h, w).to(x.dtype))
        feats = self.bottleneck(torch.cat(outs, dim=1))
        return self.cls_seg(feats), feats


@HEADS.register_module()
class DMHead(APCHead):
    """``APCHead`` under DMNet's name, as in the JAX file."""


@HEADS.register_module()
class EMAHead(BaseDecodeHead):

    def __init__(self, in_channels: int = 2048, channels: int = 512,
                 num_classes: int = 19, ema_channels: int = 512,
                 num_bases: int = 64, num_stages: int = 3,
                 momentum: float = 0.1, in_index=3, **kwargs):
        super().__init__(in_channels, channels, num_classes,
                         in_index=in_index, **kwargs)
        self.num_stages, self.momentum = num_stages, momentum
        self.ema_in = ConvModule(in_channels, ema_channels, 3, padding=1,
                                 norm_cfg=self.norm_cfg)
        self.register_buffer('bases', torch.zeros(1, num_bases, ema_channels))
        self.ema_out = ConvModule(ema_channels, ema_channels, 1,
                                  norm_cfg=self.norm_cfg, act_cfg=_NO_ACT)
        self.bottleneck = ConvModule(in_channels + ema_channels, channels, 3,
                                     padding=1, norm_cfg=self.norm_cfg)

    def draw_(self, generator: torch.Generator):
        """The JAX file's initial bases: normal / sqrt(C)."""
        c = self.bases.shape[-1]
        self.bases.copy_(torch.randn(self.bases.shape, generator=generator)
                         * (1.0 / c**0.5))

    def forward(self, inputs):
        x = self._transform_inputs(inputs)
        y = self.ema_in(x)
        b, _, h, w = y.shape
        with torch.autocast(y.device.type, enabled=False):
            feat = tokens(y).float()                          # (B, N, C)
            with torch.no_grad():
                mu = self.bases.expand(b, -1, -1)
                for _ in range(self.num_stages):
                    z = torch.softmax(torch.matmul(feat, mu.transpose(1, 2)),
                                      dim=-1)
                    z = z / (z.sum(1, keepdim=True) + 1e-6)
                    mu = torch.matmul(z.transpose(1, 2), feat)
                    mu = mu / (torch.linalg.vector_norm(
                        mu, dim=-1, keepdim=True) + 1e-6)
                if self.training and self.momentum > 0:
                    new = mu.mean(0, keepdim=True)
                    new = new / (torch.linalg.vector_norm(
                        new, dim=-1, keepdim=True) + 1e-6)
                    self.bases.copy_((1.0 - self.momentum) * self.bases
                                     + self.momentum * new)
            z = torch.softmax(torch.matmul(feat, mu.transpose(1, 2)), dim=-1)
            recon = torch.matmul(z, mu)
        y = F.relu(y + self.ema_out(as_map(recon, h, w).to(y.dtype)))
        feats = self.bottleneck(torch.cat([x, y], dim=1))
        return self.cls_seg(feats), feats
