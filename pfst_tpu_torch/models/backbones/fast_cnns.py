"""Real-time CNN backbones on NCHW tensors: Fast-SCNN, CGNet, ERFNet,
STDC, BiSeNetV1/V2 and ICNet (port of ``pfst_tpu/models/backbones/
fast_cnns.py``).

Each follows the JAX file, which keeps the stage and branch structure of
the mmseg families but not their every layer:

* ``FastSCNN``: learning-to-downsample (a conv, two depthwise-separable
  convs), the global feature extractor (three stages of three
  ``InvertedResidual``s, a 1x1 conv), and the fusion of the resized
  global features with the higher-resolution ones; returns ``(higher,
  global, fused)`` at ``out_indices``;
* ``CGNet``: three stem convs, the input resized and concatenated, then
  two stages of context-guided blocks (``_CGBlock``: a local and a
  dilated surrounding depthwise conv, BN and ``leaky_relu`` 0.01 where
  mmseg uses PReLU, a gate of two Dense layers on the pooled features);
* ``ERFNet``: per stage a stride-2 conv concatenated with a 2x2 max
  pool, then the non-bottleneck-1d blocks ((3,1) and (1,3) convs, the
  ``norm_cfg=None`` ones with a bias, the second pair dilated);
* ``STDCNet``: two stride-2 stem convs, then per stage blocks of
  ``num_convs`` convs (1x1, then 3x3, the second carrying a block's
  stride) whose outputs are concatenated, the part widths ``ch //
  2**min(i + 1, num_convs - 1)``; a stride-2 block's first part through
  a 3x3/2 average pool that counts the zero padding, as flax's does;
* ``STDCContextPathNet``: the context path on an ``STDCNet``: attention
  refinement of the two deepest stages (``arm{i}_conv``,
  ``arm{i}_atten``), the global context (``conv_avg``), the refined maps
  brought up nearest (``arm_out_conv{i}``), and the feature fusion of the
  stride-8 stage with them (``ffm_conv0``; ``ffm_att1``, ``ffm_att2``
  without a norm); its norm is BN where the config leaves ``norm_cfg``
  unset. Returns ``(stage 8, arm 32 up, arm 16 up, fused)``;
* ``BiSeNetV2``: the detail branch, the semantic branch of
  ``InvertedResidual``s (its outputs taken before the context embedding
  is added) and the bilateral guided aggregation;
* ``BiSeNetV1``: the spatial path, the context path on a ResNet with its
  attention refinement, and the feature fusion;
* ``ICNet``: the light full-resolution branch, the backbone on the input
  resized by 0.5 (``ops.resize``, sizes rounded down as the JAX file
  rounds them), its ``PPM`` and bottleneck, and the projections.

A sub-backbone sits where flax puts it: in a module named ``context``
(BiSeNetV1) or ``backbone`` (ICNet, STDC's context path) under its
class's auto-name (``ResNet_0``, ``ResNetV1c_0``, ``STDCNet_0``), with
the port's ResNet names inside.
Every other module has the JAX file's name, mapped by ``core.convert``'s
``cnn`` family. Each backbone declares ``feature_channels``, the widths
of its outputs, which the segmentor builds the heads at.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops import resize
from ..builder import BACKBONES, build_backbone
from ..decode_heads.psp_head import PPM
from ..utils.layers import (ConvModule, DepthwiseSeparableConvModule, Norm,
                            norm_name)
from .mobilenet import InvertedResidual

_NO_ACT = {'type': 'none'}
_SIGMOID = {'type': 'Sigmoid'}


def _gap(x):
    return x.mean(dim=(2, 3), keepdim=True)


def _up(x, like, align_corners=False):
    return resize(x, size=like.shape[2:], mode='bilinear',
                  align_corners=align_corners)


@BACKBONES.register_module()
class FastSCNN(nn.Module):

    key_family = 'cnn'      # core.convert's key map

    def __init__(self,
                 in_channels: int = 3,
                 downsample_dw_channels: Sequence[int] = (32, 48),
                 global_in_channels: int = 64,
                 global_block_channels: Sequence[int] = (64, 96, 128),
                 global_block_strides: Sequence[int] = (2, 2, 1),
                 global_out_channels: int = 128,
                 fusion_out_channels: int = 128,
                 out_indices: Sequence[int] = (0, 1, 2),
                 norm_cfg: Optional[dict] = None,
                 align_corners: bool = False):
        super().__init__()
        c1, c2 = downsample_dw_channels
        self.out_indices = tuple(out_indices)
        self.align_corners = align_corners
        self.ds_conv = ConvModule(in_channels, c1, 3, stride=2, padding=1,
                                  norm_cfg=norm_cfg)
        self.ds_dw1 = DepthwiseSeparableConvModule(c1, c2, 3, stride=2,
                                                   padding=1,
                                                   norm_cfg=norm_cfg)
        self.ds_dw2 = DepthwiseSeparableConvModule(
            c2, global_in_channels, 3, stride=2, padding=1, norm_cfg=norm_cfg)
        self.gfe = []
        ch = global_in_channels
        for i, (c, s) in enumerate(zip(global_block_channels,
                                       global_block_strides)):
            for b in range(3):
                self.add_module(f'gfe{i}_{b}', InvertedResidual(
                    ch, c, stride=s if b == 0 else 1, expand_ratio=6,
                    norm_cfg=norm_cfg))
                self.gfe.append(f'gfe{i}_{b}')
                ch = c
        self.gfe_out = ConvModule(ch, global_out_channels, 1,
                                  norm_cfg=norm_cfg)
        self.ffm_low = DepthwiseSeparableConvModule(
            global_out_channels, fusion_out_channels, 3, padding=1,
            norm_cfg=norm_cfg)
        self.ffm_high = ConvModule(global_in_channels, fusion_out_channels,
                                   1, norm_cfg=norm_cfg, act_cfg=_NO_ACT)
        widths = (global_in_channels, global_out_channels,
                  fusion_out_channels)
        self.feature_channels = tuple(widths[i] for i in self.out_indices)

    def forward(self, x):
        higher = self.ds_dw2(self.ds_dw1(self.ds_conv(x)))
        y = higher
        for name in self.gfe:
            y = getattr(self, name)(y)
        y = self.gfe_out(y)
        lower = self.ffm_low(_up(y, higher, self.align_corners))
        fused = F.relu(lower + self.ffm_high(higher))
        outs = (higher, y, fused)
        return tuple(outs[i] for i in self.out_indices)


class _NormLayer(nn.Module):
    """The JAX file's standalone ``Norm`` module: its layer under mmcv's
    norm name (``bn``), as flax's ``Norm`` holds it."""

    def __init__(self, features: int, norm_cfg: Optional[dict]):
        super().__init__()
        self.name = norm_name(norm_cfg)
        self.add_module(self.name, Norm(features, norm_cfg))

    def forward(self, x):
        return getattr(self, self.name)(x)


class _CGBlock(nn.Module):

    def __init__(self, in_channels: int, out_channels: int,
                 dilation: int = 2, stride: int = 1,
                 norm_cfg: Optional[dict] = None):
        super().__init__()
        n = out_channels // 2
        down = stride == 2
        self.reduce = ConvModule(in_channels, n, 3 if down else 1,
                                 stride=stride, padding=1 if down else 0,
                                 norm_cfg=norm_cfg)
        self.f_loc = ConvModule(n, n, 3, padding=1, groups=n,
                                act_cfg=_NO_ACT)
        self.f_sur = ConvModule(n, n, 3, padding=dilation, dilation=dilation,
                                groups=n, act_cfg=_NO_ACT)
        self.bn = _NormLayer(2 * n, norm_cfg)
        self.fc1 = nn.Linear(2 * n, out_channels // 4)
        self.fc2 = nn.Linear(out_channels // 4, out_channels)
        self.residual = stride == 1 and in_channels == out_channels

    def forward(self, x):
        y = self.reduce(x)
        joi = torch.cat([self.f_loc(y), self.f_sur(y)], dim=1)
        joi = F.leaky_relu(self.bn(joi), negative_slope=0.01)
        g = self.fc2(F.relu(self.fc1(joi.mean(dim=(2, 3)))))
        out = joi * torch.sigmoid(g)[:, :, None, None]
        return out + x if self.residual else out


@BACKBONES.register_module()
class CGNet(nn.Module):

    key_family = 'cnn'      # core.convert's key map

    def __init__(self,
                 in_channels: int = 3,
                 num_channels: Sequence[int] = (32, 64, 128),
                 num_blocks: Sequence[int] = (3, 21),
                 dilations: Sequence[int] = (2, 4),
                 norm_cfg: Optional[dict] = None):
        super().__init__()
        ch = in_channels
        for i in range(3):
            self.add_module(f'stem{i}', ConvModule(
                ch, num_channels[0], 3, stride=2 if i == 0 else 1, padding=1,
                norm_cfg=norm_cfg))
            ch = num_channels[0]
        ch += in_channels
        widths = [ch]
        self.stages = []
        for si in range(2):
            names = []
            for b in range(num_blocks[si]):
                self.add_module(f'stage{si}_block{b}', _CGBlock(
                    ch, num_channels[si + 1], dilations[si],
                    stride=2 if b == 0 else 1, norm_cfg=norm_cfg))
                names.append(f'stage{si}_block{b}')
                ch = num_channels[si + 1]
            self.stages.append(names)
            widths.append(ch)
        self.feature_channels = tuple(widths)

    def forward(self, x):
        y = self.stem2(self.stem1(self.stem0(x)))
        y = torch.cat([y, _up(x, y)], dim=1)
        outs = [y]
        for names in self.stages:
            for name in names:
                y = getattr(self, name)(y)
            outs.append(y)
        return tuple(outs)


@BACKBONES.register_module()
class ERFNet(nn.Module):
    """The encoder: downsamplers and non-bottleneck-1d blocks."""

    key_family = 'cnn'      # core.convert's key map

    def __init__(self,
                 in_channels: int = 3,
                 enc_downsample_channels: Sequence[int] = (16, 64, 128),
                 enc_stage_non_bottlenecks: Sequence[int] = (5, 8),
                 dilations_per_stage: Sequence[Sequence[int]] = (
                     (1,), (2, 4, 8, 16)),
                 norm_cfg: Optional[dict] = None):
        super().__init__()
        self.stages = []
        ch = in_channels
        widths = []
        for si, c in enumerate(enc_downsample_channels):
            conv_ch = max(c - ch, 1)
            self.add_module(f'down{si}', ConvModule(
                ch, conv_ch, 3, stride=2, padding=1, norm_cfg=norm_cfg))
            ch += conv_ch
            blocks = []
            if si > 0:
                dils = dilations_per_stage[si - 1]
                for b in range(enc_stage_non_bottlenecks[si - 1]):
                    d = dils[b % len(dils)]
                    for k, (kernel, pad, dil, norm, act) in enumerate((
                            ((3, 1), (1, 0), 1, None, None),
                            ((1, 3), (0, 1), 1, norm_cfg, None),
                            ((3, 1), (d, 0), (d, 1), None, None),
                            ((1, 3), (0, d), (1, d), norm_cfg, _NO_ACT))):
                        self.add_module(f's{si}b{b}_c{k + 1}', ConvModule(
                            ch, ch, kernel, padding=pad, dilation=dil,
                            norm_cfg=norm, act_cfg=act))
                    blocks.append(f's{si}b{b}')
            self.stages.append(blocks)
            widths.append(ch)
        self.feature_channels = tuple(widths)

    def forward(self, x):
        outs = []
        for si, blocks in enumerate(self.stages):
            x = torch.cat([getattr(self, f'down{si}')(x),
                           F.max_pool2d(x, 2, 2)], dim=1)
            for b in blocks:
                y = x
                for k in range(1, 5):
                    y = getattr(self, f'{b}_c{k}')(y)
                x = F.relu(y + x)
            outs.append(x)
        return tuple(outs)


class _SubBackbone(nn.Module):
    """The JAX file's ``_SubBackbone``: the backbone of ``cfg`` under flax's
    auto-name for it, its class's name and ``_0``."""

    def __init__(self, cfg: dict):
        super().__init__()
        backbone = build_backbone(dict(cfg))
        self.name = f'{type(backbone).__name__}_0'
        self.add_module(self.name, backbone)
        widths = getattr(backbone, 'feature_channels', None)
        if widths is None:      # a ResNet: each stage's last block
            last = [getattr(backbone, n)[-1] for n in backbone.res_layers]
            widths = [blk.expansion * blk.conv1.out_channels for blk in last]
            widths = [widths[i] for i in backbone.out_indices]
        self.feature_channels = tuple(widths)

    def forward(self, x):
        return getattr(self, self.name)(x)


@BACKBONES.register_module()
class STDCNet(nn.Module):
    """Short-term dense concatenation stages (STDCNet1: one block a
    stage, as the JAX file has it)."""

    key_family = 'cnn'      # core.convert's key map

    def __init__(self,
                 stdc_type: str = 'STDCNet1',
                 in_channels: int = 3,
                 channels: Sequence[int] = (32, 64, 256, 512, 1024),
                 bottleneck_type: str = 'cat',
                 num_convs: int = 4,
                 out_indices: Sequence[int] = (2, 3, 4),
                 with_final_conv: bool = False,
                 norm_cfg: Optional[dict] = None,
                 act_cfg: Optional[dict] = None):
        super().__init__()
        # bottleneck_type and act_cfg are accepted and unused, as in the
        # JAX file
        del bottleneck_type, act_cfg
        self.blocks = {'STDCNet1': (1, 1, 1), 'STDCNet2': (3, 4, 2)}[
            stdc_type]
        self.num_convs = num_convs
        self.out_indices = tuple(out_indices)
        self.stem0 = ConvModule(in_channels, channels[0], 3, stride=2,
                                padding=1, norm_cfg=norm_cfg)
        self.stem1 = ConvModule(channels[0], channels[1], 3, stride=2,
                                padding=1, norm_cfg=norm_cfg)
        width = channels[1]
        for si, nb in enumerate(self.blocks):
            ch = channels[si + 2]
            for b in range(nb):
                cin = width
                for ci in range(num_convs):
                    part = ch // 2**min(ci + 1, num_convs - 1)
                    self.add_module(f's{si}b{b}c{ci}', ConvModule(
                        cin, part, 1 if ci == 0 else 3,
                        stride=2 if ci == 1 and b == 0 else 1,
                        padding=0 if ci == 0 else 1, norm_cfg=norm_cfg))
                    cin = part
                width = ch
        self.with_final_conv = with_final_conv
        if with_final_conv:
            self.final_conv = ConvModule(width, channels[-1], 1,
                                         norm_cfg=norm_cfg)
        widths = list(channels[2:])
        if with_final_conv:
            widths[-1] = channels[-1]
        self.feature_channels = tuple(widths[i - 2] for i in self.out_indices)

    def forward(self, x):
        x = self.stem1(self.stem0(x))
        outs = []
        for si, nb in enumerate(self.blocks):
            for b in range(nb):
                parts, y = [], x
                for ci in range(self.num_convs):
                    y = getattr(self, f's{si}b{b}c{ci}')(y)
                    parts.append(y)
                if b == 0:
                    parts[0] = F.avg_pool2d(parts[0], 3, 2, 1,
                                            count_include_pad=True)
                x = torch.cat(parts, dim=1)
            outs.append(x)
        if self.with_final_conv:
            outs[-1] = self.final_conv(outs[-1])
        return tuple(outs[i - 2] for i in self.out_indices)


@BACKBONES.register_module()
class STDCContextPathNet(nn.Module):
    """``STDCNet`` and its context path."""

    key_family = 'cnn'      # core.convert's key map

    def __init__(self,
                 backbone_cfg: Optional[dict] = None,
                 last_in_channels: Sequence[int] = (1024, 512),
                 out_channels: int = 128,
                 ffm_cfg: Optional[dict] = None,
                 upsample_mode: str = 'nearest',
                 align_corners: Optional[bool] = None,
                 norm_cfg: Optional[dict] = None):
        super().__init__()
        # the JAX file defaults the context path's norm to BN
        norm_cfg = norm_cfg if norm_cfg is not None else {'type': 'BN'}
        self.backbone = _SubBackbone(backbone_cfg or dict(
            type='STDCNet', norm_cfg=norm_cfg))
        widths = self.backbone.feature_channels
        self.n_arms = len(last_in_channels)
        self.upsample_mode = upsample_mode
        self.align_corners = bool(align_corners)
        c = out_channels
        self.conv_avg = ConvModule(widths[-1], c, 1, norm_cfg=norm_cfg)
        for i in range(self.n_arms):
            self.add_module(f'arm{i}_conv', ConvModule(
                widths[-1 - i], c, 3, padding=1, norm_cfg=norm_cfg))
            self.add_module(f'arm{i}_atten', ConvModule(
                c, c, 1, bias=False, norm_cfg=norm_cfg, act_cfg=_NO_ACT))
            self.add_module(f'arm_out_conv{i}', ConvModule(
                c, c, 3, padding=1, norm_cfg=norm_cfg))
        ffm = dict(ffm_cfg or dict(in_channels=384, out_channels=256,
                                   scale_factor=4))
        fo = ffm['out_channels']
        self.ffm_conv0 = ConvModule(widths[0] + c, fo, 1, norm_cfg=norm_cfg)
        self.ffm_att1 = ConvModule(fo, fo // ffm.get('scale_factor', 4), 1,
                                   bias=False)
        self.ffm_att2 = ConvModule(fo // ffm.get('scale_factor', 4), fo, 1,
                                   bias=False, act_cfg=_NO_ACT)
        self.feature_channels = (widths[0], c, c, fo)

    def _resize(self, x, like):
        return resize(x, size=like.shape[2:], mode=self.upsample_mode,
                      align_corners=self.align_corners)

    def forward(self, x):
        outs = list(self.backbone(x))
        up = self._resize(self.conv_avg(_gap(outs[-1])), outs[-1])
        arms = []
        for i in range(self.n_arms):
            y = getattr(self, f'arm{i}_conv')(outs[-1 - i])
            y = y * torch.sigmoid(getattr(self, f'arm{i}_atten')(_gap(y)))
            up = getattr(self, f'arm_out_conv{i}')(
                self._resize(y + up, outs[-2 - i]))
            arms.append(up)
        fused = self.ffm_conv0(torch.cat([outs[0], arms[1]], dim=1))
        att = self.ffm_att2(self.ffm_att1(_gap(fused)))
        return outs[0], arms[0], arms[1], fused * torch.sigmoid(att) + fused


@BACKBONES.register_module()
class BiSeNetV1(nn.Module):
    """The spatial path and the context path (a ResNet-18 by default)."""

    key_family = 'cnn'      # core.convert's key map

    def __init__(self,
                 in_channels: int = 3,
                 context_channels: Sequence[int] = (128, 256, 512),
                 spatial_channels: Sequence[int] = (64, 64, 64, 128),
                 out_channels: int = 256,
                 backbone_cfg: Optional[dict] = None,
                 out_indices: Sequence[int] = (0, 1, 2),
                 norm_cfg: Optional[dict] = None):
        super().__init__()
        self.out_indices = tuple(out_indices)
        cc0, cc1 = context_channels[0], context_channels[1]
        ch = in_channels
        for i, c in enumerate(spatial_channels[:3]):
            self.add_module(f'spatial{i}', ConvModule(
                ch, c, 7 if i == 0 else 3, stride=2,
                padding=3 if i == 0 else 1, norm_cfg=norm_cfg))
            ch = c
        self.spatial_out = ConvModule(ch, spatial_channels[3], 1,
                                      norm_cfg=norm_cfg)
        self.context = _SubBackbone(backbone_cfg or dict(
            type='ResNet', depth=18, norm_cfg=norm_cfg))
        c16, c32 = self.context.feature_channels[-2:]
        self.gap_conv = ConvModule(c32, cc1, 1, norm_cfg=norm_cfg)
        for name, cin, c in (('arm32', c32, cc1), ('arm16', c16, cc0)):
            self.add_module(f'{name}_conv', ConvModule(cin, c, 3, padding=1,
                                                       norm_cfg=norm_cfg))
            self.add_module(f'{name}_attn', ConvModule(
                c, c, 1, norm_cfg=norm_cfg, act_cfg=_SIGMOID))
        self.refine32 = ConvModule(cc1, cc0, 3, padding=1, norm_cfg=norm_cfg)
        self.refine16 = ConvModule(cc0, cc0, 3, padding=1, norm_cfg=norm_cfg)
        self.ffm_conv = ConvModule(spatial_channels[3] + cc0, out_channels, 1,
                                   norm_cfg=norm_cfg)
        self.ffm_attn1 = nn.Conv2d(out_channels, out_channels, 1)
        self.ffm_attn2 = nn.Conv2d(out_channels, out_channels, 1)
        widths = (out_channels, cc0, cc0)
        self.feature_channels = tuple(widths[i] for i in self.out_indices)

    def _arm(self, f, name):
        y = getattr(self, f'{name}_conv')(f)
        return y * getattr(self, f'{name}_attn')(_gap(y))

    def forward(self, x):
        s = x
        for i in range(3):
            s = getattr(self, f'spatial{i}')(s)
        s = self.spatial_out(s)
        feats = self.context(x)
        c16, c32 = feats[-2], feats[-1]
        r32 = self._arm(c32, 'arm32') + self.gap_conv(_gap(c32))
        r32 = self.refine32(_up(r32, c16))
        r16 = self._arm(c16, 'arm16') + r32
        r16 = self.refine16(_up(r16, s))
        ffm = self.ffm_conv(torch.cat([s, r16], dim=1))
        a = self.ffm_attn2(F.relu(self.ffm_attn1(_gap(ffm))))
        outs = (ffm + ffm * torch.sigmoid(a), r16, r32)
        return tuple(outs[i] for i in self.out_indices)


@BACKBONES.register_module()
class BiSeNetV2(nn.Module):
    """The detail branch, the semantic branch and the bilateral guided
    aggregation."""

    key_family = 'cnn'      # core.convert's key map

    def __init__(self,
                 in_channels: int = 3,
                 detail_channels: Sequence[int] = (64, 64, 128),
                 semantic_channels: Sequence[int] = (16, 32, 64, 128),
                 semantic_expansion_ratio: int = 6,
                 bga_channels: int = 128,
                 out_indices: Sequence[int] = (0, 1, 2, 3, 4),
                 norm_cfg: Optional[dict] = None):
        super().__init__()
        ch = in_channels
        for i, c in enumerate(detail_channels):
            self.add_module(f'detail{i}a', ConvModule(
                ch, c, 3, stride=2, padding=1, norm_cfg=norm_cfg))
            self.add_module(f'detail{i}b', ConvModule(c, c, 3, padding=1,
                                                      norm_cfg=norm_cfg))
            ch = c
        self.n_detail = len(detail_channels)
        self.stem = ConvModule(in_channels, semantic_channels[0], 3, stride=2,
                               padding=1, norm_cfg=norm_cfg)
        s = semantic_channels[0]
        self.n_sem = len(semantic_channels) - 1
        for i, c in enumerate(semantic_channels[1:]):
            for b in range(2):
                self.add_module(f'sem{i}_{b}', InvertedResidual(
                    s, c, stride=2 if b == 0 else 1,
                    expand_ratio=semantic_expansion_ratio,
                    norm_cfg=norm_cfg))
                s = c
        self.ce = ConvModule(s, s, 1, norm_cfg=norm_cfg)
        self.bga_sem = ConvModule(s, bga_channels, 3, padding=1,
                                  norm_cfg=norm_cfg, act_cfg=_SIGMOID)
        self.bga_det = ConvModule(ch, bga_channels, 3, padding=1,
                                  norm_cfg=norm_cfg, act_cfg=_NO_ACT)
        self.bga_out = ConvModule(bga_channels, bga_channels, 3, padding=1,
                                  norm_cfg=norm_cfg)
        widths = (bga_channels, *semantic_channels)
        self.out_indices = tuple(i for i in out_indices if i < len(widths))
        self.feature_channels = tuple(widths[i] for i in self.out_indices)

    def forward(self, x):
        d = x
        for i in range(self.n_detail):
            d = getattr(self, f'detail{i}b')(getattr(self, f'detail{i}a')(d))
        s = F.max_pool2d(self.stem(x), 3, 2, 1)
        sem_outs = [s]
        for i in range(self.n_sem):
            for b in range(2):
                s = getattr(self, f'sem{i}_{b}')(s)
            sem_outs.append(s)
        s = s + self.ce(_gap(s))
        s_up = self.bga_sem(_up(s, d))
        fused = self.bga_out(self.bga_det(d) * s_up)
        outs = [fused] + sem_outs
        return tuple(outs[i] for i in self.out_indices)


@BACKBONES.register_module()
class ICNet(nn.Module):
    """The multi-resolution backbone: the light branch at full
    resolution, the sub-backbone at half, its PPM."""

    key_family = 'cnn'      # core.convert's key map

    def __init__(self,
                 backbone_cfg: Optional[dict] = None,
                 in_channels: int = 3,
                 layer_channels: Sequence[int] = (512, 2048),
                 light_branch_middle_channels: int = 32,
                 psp_out_channels: int = 512,
                 out_channels: Sequence[int] = (64, 256, 256),
                 norm_cfg: Optional[dict] = None,
                 align_corners: bool = False):
        super().__init__()
        # layer_channels is accepted and unused, as in the JAX file
        del layer_channels
        self.align_corners = align_corners
        mid = light_branch_middle_channels
        ch = in_channels
        for i, c in enumerate((mid, mid, out_channels[0])):
            self.add_module(f'light{i}', ConvModule(ch, c, 3, stride=2,
                                                    padding=1,
                                                    norm_cfg=norm_cfg))
            ch = c
        self.backbone = _SubBackbone(backbone_cfg or dict(
            type='ResNetV1c', depth=50, dilations=(1, 1, 2, 4),
            strides=(1, 2, 1, 1), norm_cfg=norm_cfg, contract_dilation=True))
        widths = self.backbone.feature_channels
        self.mid_proj = ConvModule(widths[1], out_channels[1], 1,
                                   norm_cfg=norm_cfg)
        scales = (1, 2, 3, 6)
        self.psp = PPM(scales, widths[-1], psp_out_channels, align_corners,
                       norm_cfg=norm_cfg)
        self.psp_bottleneck = ConvModule(
            widths[-1] + len(scales) * psp_out_channels, psp_out_channels, 3,
            padding=1, norm_cfg=norm_cfg)
        self.low_proj = ConvModule(psp_out_channels, out_channels[2], 1,
                                   norm_cfg=norm_cfg)
        self.feature_channels = tuple(out_channels)

    def forward(self, x):
        hi = self.light2(self.light1(self.light0(x)))
        feats = self.backbone(resize(x, scale_factor=0.5, mode='bilinear',
                                     align_corners=self.align_corners))
        mid = self.mid_proj(feats[1])
        deep = feats[-1]
        deep = self.psp_bottleneck(torch.cat([deep, *self.psp(deep)], dim=1))
        return hi, mid, self.low_proj(deep)
