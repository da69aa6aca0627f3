"""ResNet / ResNetV1c / ResNetV1d backbones on NCHW tensors (port of
``pfst_tpu/models/backbones/resnet.py``).

Attribute names follow mmseg's ``ResNet`` (``stem.{0,1,3,4,6,7}`` or
``conv1``/``bn1``, ``layerN.M.conv1``/``bn1``/..., ``downsample.{0,1}``),
so the state dict carries the rsiseg key names. Covered:

* depths 18/34/50/101/152 (BasicBlock / Bottleneck), ``pytorch`` style
  (stride on the 3x3 conv);
* the deep 3x3x3 stem of V1c/V1d, max-pool 3x3/s2 with padding 1;
* per-stage ``strides``/``dilations`` with ``contract_dilation`` (the
  first block of a dilated stage uses ``dilation // 2``) and
  ``multi_grid``;
* ``out_indices``, ``norm_eval`` and ``frozen_stages`` (BN in eval mode
  and parameters frozen, as in mmseg);
* ``with_cp``: each block through ``torch.utils.checkpoint`` (not
  reentrant), the JAX file's ``nn.remat``, when a gradient is taken. The
  backward runs a block's forward again, and a train-mode BN would move
  its running statistics a second time on the same batch; flax's remat
  updates ``batch_stats`` once, so the recomputation puts the block's
  buffers back as it found them (``_KeepBuffers``);
* ``s2d_stem``: the JAX file's space-to-depth form of the deep stem's
  3x3/2 conv for the TPU's matrix unit (``resnet.py:95-142, 232-245``):
  the same (3, 3, cin, out) kernel under the same name, zero-padded to
  4x4 and re-blocked over 2x2 pixel blocks, the same function on the
  even sizes it takes. The port runs the usual strided conv with those
  weights.

Output stride 8 for DeepLabV3+ comes from ``strides=(1, 2, 1, 1),
dilations=(1, 1, 2, 4)``.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..builder import BACKBONES
from ..utils.layers import Norm, norm_name


def _conv(cin, cout, k, stride=1, padding=0, dilation=1):
    return nn.Conv2d(cin, cout, k, stride, padding, dilation, bias=False)


def _downsample(cin, cout, stride, avg_down, norm_cfg):
    layers = []
    if avg_down and stride != 1:
        # 'VALID' pooling as in the JAX file (mmseg pads with ceil_mode;
        # the two agree on even sizes)
        layers.append(nn.AvgPool2d(stride, stride))
        stride = 1
    layers += [_conv(cin, cout, 1, stride), Norm(cout, norm_cfg)]
    return nn.Sequential(*layers)


class _KeepBuffers:
    """Restores ``module``'s buffers (BN statistics and counts) on exit to
    what they were on entry: the context of a checkpointed block's
    recomputation."""

    def __init__(self, module: nn.Module):
        self.module = module

    def __enter__(self):
        self.saved = [b.clone() for b in self.module.buffers()]

    def __exit__(self, *exc):
        with torch.no_grad():
            for b, saved in zip(self.module.buffers(), self.saved):
                b.copy_(saved)


def _checkpointed(block, x):
    return checkpoint(block, x, use_reentrant=False, context_fn=lambda: (
        contextlib.nullcontext(), _KeepBuffers(block)))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, dilation=1,
                 with_downsample=False, avg_down=False, norm_cfg=None):
        super().__init__()
        n = norm_name(norm_cfg)
        self.norm1_name, self.norm2_name = f'{n}1', f'{n}2'
        self.conv1 = _conv(inplanes, planes, 3, stride, dilation, dilation)
        self.add_module(self.norm1_name, Norm(planes, norm_cfg))
        self.conv2 = _conv(planes, planes, 3, 1, 1)
        self.add_module(self.norm2_name, Norm(planes, norm_cfg))
        self.downsample = _downsample(inplanes, planes, stride, avg_down,
                                      norm_cfg) if with_downsample else None

    def forward(self, x):
        out = F.relu(getattr(self, self.norm1_name)(self.conv1(x)))
        out = getattr(self, self.norm2_name)(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, dilation=1,
                 with_downsample=False, avg_down=False, norm_cfg=None):
        super().__init__()
        n = norm_name(norm_cfg)
        self.norm_names = (f'{n}1', f'{n}2', f'{n}3')
        self.conv1 = _conv(inplanes, planes, 1)
        self.add_module(self.norm_names[0], Norm(planes, norm_cfg))
        # pytorch-style: stride lives on the 3x3 conv
        self.conv2 = _conv(planes, planes, 3, stride, dilation, dilation)
        self.add_module(self.norm_names[1], Norm(planes, norm_cfg))
        self.conv3 = _conv(planes, planes * self.expansion, 1)
        self.add_module(self.norm_names[2],
                        Norm(planes * self.expansion, norm_cfg))
        self.downsample = _downsample(
            inplanes, planes * self.expansion, stride, avg_down,
            norm_cfg) if with_downsample else None

    def forward(self, x):
        n1, n2, n3 = (getattr(self, n) for n in self.norm_names)
        out = F.relu(n1(self.conv1(x)))
        out = F.relu(n2(self.conv2(out)))
        out = n3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


@BACKBONES.register_module()
class ResNet(nn.Module):
    """ResNet backbone returning the feature maps at ``out_indices``."""

    arch_settings = {
        18: (BasicBlock, (2, 2, 2, 2)),
        34: (BasicBlock, (3, 4, 6, 3)),
        50: (Bottleneck, (3, 4, 6, 3)),
        101: (Bottleneck, (3, 4, 23, 3)),
        152: (Bottleneck, (3, 8, 36, 3)),
    }
    default_deep_stem = False
    default_avg_down = False

    def __init__(self,
                 depth: int = 50,
                 in_channels: int = 3,
                 stem_channels: int = 64,
                 base_channels: int = 64,
                 num_stages: int = 4,
                 strides: Sequence[int] = (1, 2, 2, 2),
                 dilations: Sequence[int] = (1, 1, 1, 1),
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 style: str = 'pytorch',
                 deep_stem: Optional[bool] = None,
                 avg_down: Optional[bool] = None,
                 frozen_stages: int = -1,
                 norm_cfg: Optional[dict] = None,
                 norm_eval: bool = False,
                 contract_dilation: bool = False,
                 multi_grid: Optional[Sequence[int]] = None,
                 zero_init_residual: bool = True,
                 with_cp: bool = False,
                 s2d_stem: bool = False,
                 pretrained: Optional[str] = None,
                 init_cfg: Optional[dict] = None):
        super().__init__()
        # zero_init_residual, pretrained and init_cfg are accepted for
        # config compatibility; as in the JAX file they change nothing
        del zero_init_residual, pretrained, init_cfg
        if depth not in self.arch_settings:
            raise KeyError(f'invalid depth {depth} for resnet')
        if style != 'pytorch':
            raise ValueError(f'only pytorch-style blocks, got {style!r}')
        # s2d_stem is the same function as the usual stem (above)
        del s2d_stem
        self.with_cp = with_cp
        deep_stem = self.default_deep_stem if deep_stem is None \
            else deep_stem
        avg_down = self.default_avg_down if avg_down is None else avg_down
        block_cls, stage_blocks = self.arch_settings[depth]
        stage_blocks = stage_blocks[:num_stages]
        self.out_indices = tuple(out_indices)
        self.deep_stem = deep_stem
        self.norm_eval = norm_eval
        self.frozen_stages = frozen_stages

        if deep_stem:
            half = stem_channels // 2
            self.stem = nn.Sequential(
                _conv(in_channels, half, 3, 2, 1), Norm(half, norm_cfg),
                nn.ReLU(inplace=True),
                _conv(half, half, 3, 1, 1), Norm(half, norm_cfg),
                nn.ReLU(inplace=True),
                _conv(half, stem_channels, 3, 1, 1),
                Norm(stem_channels, norm_cfg), nn.ReLU(inplace=True))
        else:
            self.norm1_name = f'{norm_name(norm_cfg)}1'
            self.conv1 = _conv(in_channels, stem_channels, 7, 2, 3)
            self.add_module(self.norm1_name, Norm(stem_channels, norm_cfg))
        self.maxpool = nn.MaxPool2d(3, 2, 1)

        inplanes = stem_channels
        self.res_layers = []
        for i, num_blocks in enumerate(stage_blocks):
            planes = base_channels * 2**i
            blocks = []
            for b in range(num_blocks):
                if multi_grid is not None and i == len(stage_blocks) - 1:
                    blk_dilation = multi_grid[b]
                elif b == 0 and dilations[i] > 1 and contract_dilation:
                    blk_dilation = dilations[i] // 2
                else:
                    blk_dilation = dilations[i]
                blk_stride = strides[i] if b == 0 else 1
                out_ch = planes * block_cls.expansion
                with_down = b == 0 and (blk_stride != 1 or inplanes != out_ch)
                blocks.append(block_cls(inplanes, planes, blk_stride,
                                        blk_dilation, with_down, avg_down,
                                        norm_cfg))
                inplanes = out_ch
            name = f'layer{i + 1}'
            self.add_module(name, nn.Sequential(*blocks))
            self.res_layers.append(name)
        self._freeze_stages()

    def _frozen_modules(self):
        if self.frozen_stages >= 0:
            yield self.stem if self.deep_stem else nn.ModuleList(
                [self.conv1, getattr(self, self.norm1_name)])
        for i in range(1, self.frozen_stages + 1):
            yield getattr(self, f'layer{i}')

    def _freeze_stages(self):
        for m in self._frozen_modules():
            m.eval()
            for p in m.parameters():
                p.requires_grad_(False)

    def train(self, mode: bool = True):
        """BN of frozen stages, and all BN under ``norm_eval``, stays in
        eval mode (the JAX file's ``_stage_train``)."""
        super().train(mode)
        self._freeze_stages()
        if mode and self.norm_eval:
            for m in self.modules():
                if isinstance(m, nn.modules.batchnorm._BatchNorm):
                    m.eval()
        return self

    def forward(self, x):
        if self.deep_stem:
            x = self.stem(x)
        else:
            x = F.relu(getattr(self, self.norm1_name)(self.conv1(x)))
        x = self.maxpool(x)
        outs = []
        cp = self.with_cp and torch.is_grad_enabled()
        for i, name in enumerate(self.res_layers):
            for block in getattr(self, name):
                x = _checkpointed(block, x) if cp else block(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)


@BACKBONES.register_module()
class ResNetV1c(ResNet):
    """ResNet with deep 3x3x3 stem (``rsiseg`` ``resnet.py:689-701``)."""
    default_deep_stem = True


@BACKBONES.register_module()
class ResNetV1d(ResNet):
    """Deep stem + avg-pool downsampling (``rsiseg`` ``resnet.py:704``)."""
    default_deep_stem = True
    default_avg_down = True
