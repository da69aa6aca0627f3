"""Transformer-decoder heads on NCHW maps: SETR (naive, PUP, MLA) and
Segmenter (port of ``pfst_tpu/models/decode_heads/transformer_heads.py``).

* ``SETRUPHead`` (``:21-54``): a LayerNorm over the channels of each
  pixel (``norm``), ``num_convs`` x (ConvModule, bilinear x``up_scale``)
  under mmseg's ``up_convs.{i}.0``, then the classifier.
* ``SETRMLAHead`` (``:57-96``): per level one 3x3 ConvModule, resized to
  level 0's size x ``up_scale``, concatenated, classified. mmseg's head
  runs two convs a level; this head keeps the JAX file's one, under its
  names (``mla_conv.{i}``, the JAX ``mla_conv{i}``).
* ``SegmenterMaskTransformerHead`` (``:99-170``): patch tokens projected
  (``dec_proj``), learned class tokens (``cls_emb``) appended, ``layers``
  of pre-norm transformer blocks (the ViT's ``ViTBlock``, so their
  attention goes through ``ops.attention``: the flash kernels on the
  card, the plain version on the CPU), ``decoder_norm``, then the masks
  as the product of the L2-normalised ``patch_proj`` and
  ``classes_proj`` outputs (a norm plus 1e-6, as the JAX file divides).
  mmseg's names; like the JAX file it has no ``mask_norm`` and its
  projections carry a bias.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from ...ops import resize
from ..backbones.vit import ViTBlock
from ..builder import HEADS
from ..utils.layers import ChannelLayerNorm, ConvModule, init_flax_defaults_
from .base import BaseDecodeHead, Upsample


@HEADS.register_module()
class SETRUPHead(BaseDecodeHead):

    def __init__(self, in_channels: int = 768, channels: int = 256,
                 num_classes: int = 19, num_convs: int = 4,
                 up_scale: int = 2, kernel_size: int = 3, **kwargs):
        super().__init__(in_channels, channels, num_classes, **kwargs)
        # flax's nn.LayerNorm over the channels, eps 1e-6
        self.norm = ChannelLayerNorm(in_channels)
        self.up_convs = nn.ModuleList(
            nn.Sequential(
                ConvModule(in_channels if i == 0 else channels, channels,
                           kernel_size, padding=kernel_size // 2,
                           norm_cfg=self.norm_cfg),
                Upsample(up_scale, self.align_corners))
            for i in range(num_convs))

    def forward(self, inputs):
        x = self.norm(self._transform_inputs(inputs))
        for up_conv in self.up_convs:
            x = up_conv(x)
        return self.cls_seg(x), x


@HEADS.register_module()
class SETRMLAHead(BaseDecodeHead):

    def __init__(self, in_channels: Sequence[int] = (256,) * 4,
                 channels: int = 512, num_classes: int = 19,
                 mla_channels: int = 128, up_scale: int = 4,
                 in_index=(0, 1, 2, 3), input_transform='multiple_select',
                 **kwargs):
        super().__init__(list(in_channels), channels, num_classes,
                         in_index=list(in_index),
                         input_transform=input_transform, **kwargs)
        self.up_scale = up_scale
        self.mla_conv = nn.ModuleList(
            ConvModule(c, mla_channels, 3, padding=1, norm_cfg=self.norm_cfg)
            for c in in_channels)

    def forward(self, inputs):
        feats = [inputs[i] for i in self.in_index]
        # the levels of a plain ViT share one size; like the JAX file,
        # align to level 0's, upsampled
        size = (feats[0].shape[2] * self.up_scale,
                feats[0].shape[3] * self.up_scale)
        x = torch.cat([resize(conv(f), size=size, mode='bilinear',
                              align_corners=self.align_corners)
                       for conv, f in zip(self.mla_conv, feats)], dim=1)
        return self.cls_seg(x), x


@HEADS.register_module()
class SegmenterMaskTransformerHead(BaseDecodeHead):

    def __init__(self, in_channels: int = 768, channels: int = 768,
                 num_classes: int = 19, num_layers: int = 2,
                 num_heads: int = 12, embed_dims: int = 768,
                 dropout_ratio: float = 0.0, **kwargs):
        super().__init__(in_channels, channels, num_classes,
                         dropout_ratio=dropout_ratio, **kwargs)
        # the masks are the logits: no dropout, no 1x1 classifier (mmseg
        # deletes it too)
        del self.conv_seg
        self.dropout = None
        d = embed_dims
        self.dec_proj = nn.Linear(in_channels, d)
        self.cls_emb = nn.Parameter(torch.zeros(1, num_classes, d))
        self.layers = nn.ModuleList(ViTBlock(d, num_heads)
                                    for _ in range(num_layers))
        self.decoder_norm = nn.LayerNorm(d, eps=1e-6)
        self.patch_proj = nn.Linear(d, d)
        self.classes_proj = nn.Linear(d, d)

    def init_weights(self, generator: torch.Generator):
        """The JAX file's initializers: flax's default Dense (lecun-normal,
        zero bias), LayerNorms at 1 and 0, ``cls_emb``
        truncated-normal(0.02)."""
        with torch.no_grad():
            init_flax_defaults_(self, generator)
            nn.init.trunc_normal_(self.cls_emb, 0.0, 0.02, -0.04, 0.04,
                                  generator=generator)
        return self

    def forward(self, inputs):
        x = self._transform_inputs(inputs)
        b, c, h, w = x.shape
        seq = self.dec_proj(x.flatten(2).transpose(1, 2))
        # under autocast, as under the JAX file's bf16, the fp32 class
        # tokens promote the sequence to fp32
        seq = torch.cat([seq, self.cls_emb.expand(b, -1, -1)], dim=1)
        for layer in self.layers:
            seq = layer(seq)
        seq = self.decoder_norm(seq)
        patches = self.patch_proj(seq[:, :h * w])
        cls = self.classes_proj(seq[:, h * w:])
        patches = patches / (torch.linalg.vector_norm(
            patches, dim=-1, keepdim=True) + 1e-6)
        cls = cls / (torch.linalg.vector_norm(cls, dim=-1, keepdim=True)
                     + 1e-6)
        masks = torch.matmul(patches, cls.transpose(1, 2))   # (B, hw, K)
        logits = masks.transpose(1, 2).reshape(b, self.num_classes, h, w)
        feats = seq[:, :h * w].transpose(1, 2).reshape(b, -1, h, w)
        return logits, feats
