"""Shared conv/norm building blocks on NCHW tensors (port of
``pfst_tpu/models/utils/layers.py``).

mmcv's ``ConvModule`` / ``DepthwiseSeparableConvModule`` with mmcv's
attribute names (``conv``, then ``bn``/``gn``/``ln``/``in`` for the
norm), so state dicts carry the rsiseg key names. Norms follow the
``norm_cfg`` dicts: ``BN`` is batch norm with torch momentum 0.1 and
eps 1e-5; ``SyncBN`` is ``parallel.SyncBatchNorm``, the same layer
whose train-mode statistics span the replicas of a data-parallel step;
``GN``, ``LN`` (over channels, per pixel) and ``IN`` (one channel per
group) are as in the JAX file.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...parallel.sync_bn import SyncBatchNorm

_NORM_NAMES = {'BN': 'bn', 'BN2d': 'bn', 'SyncBN': 'bn', 'GN': 'gn',
               'LN': 'ln', 'IN': 'in', 'none': 'norm', None: 'norm'}
# flax's variance_scaling 'truncated_normal' divides the target std by
# the std of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def pad_same(x: torch.Tensor, stride: int) -> torch.Tensor:
    """(B, C, H, W) zero-padded as flax's ``padding='SAME'`` pads a conv
    whose kernel is its stride: each side up to a multiple of ``stride``,
    the smaller half of the padding before."""
    ph, pw = (-x.shape[2]) % stride, (-x.shape[3]) % stride
    if not ph and not pw:
        return x
    return F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))


def init_conv_(weight: torch.Tensor, generator: torch.Generator):
    """The JAX convs' initializer (``layers.py:126-127``):
    ``variance_scaling(2.0, 'fan_out', 'truncated_normal')``."""
    out_ch, _, kh, kw = weight.shape
    std = math.sqrt(2.0 / (out_ch * kh * kw)) / _TRUNC_STD
    nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std,
                          generator=generator)


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator):
    """flax's default kernel initializer, ``lecun_normal``:
    ``variance_scaling(1.0, 'fan_in', 'truncated_normal')``, with the
    fan-in of a torch weight (out, in, ...) taken over all but dim 0."""
    std = math.sqrt(1.0 / weight[0].numel()) / _TRUNC_STD
    nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std,
                          generator=generator)


def init_flax_defaults_(module: nn.Module, generator: torch.Generator):
    """flax's default initializers on every Dense and Conv of ``module``
    (the attention's in-projection among them): lecun-normal kernels, zero
    biases; LayerNorms at scale 1 and bias 0."""
    for m in module.modules():
        weight = getattr(m, 'in_proj_weight', None)
        if weight is None and isinstance(m, (nn.Linear, nn.Conv2d)):
            weight = m.weight
        if weight is not None:
            lecun_normal_(weight, generator)
            getattr(m, 'in_proj_bias', getattr(m, 'bias', None)).zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()


class ChannelLayerNorm(nn.Module):
    """LayerNorm over the channels of each pixel of an NCHW map (flax's
    ``nn.LayerNorm`` on the last axis of NHWC)."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.eps = eps

    def forward(self, x):
        x = x.permute(0, 2, 3, 1)
        x = F.layer_norm(x, x.shape[-1:], self.weight, self.bias, self.eps)
        return x.permute(0, 3, 1, 2)


def norm_name(norm_cfg: Optional[dict]) -> str:
    """mmcv's attribute name for the norm of ``norm_cfg``."""
    kind = (norm_cfg or {'type': 'BN'}).get('type', 'BN')
    if kind not in _NORM_NAMES:
        raise ValueError(f'unsupported norm type {kind}')
    return _NORM_NAMES[kind]


def Norm(features: int, norm_cfg: Optional[dict] = None) -> nn.Module:
    """Norm layer for a ``norm_cfg``-style dict."""
    cfg = dict(norm_cfg or {'type': 'BN'})
    kind = cfg.pop('type', 'BN')
    requires_grad = cfg.pop('requires_grad', True)
    if kind in ('BN', 'BN2d', 'SyncBN'):
        cls = SyncBatchNorm if kind == 'SyncBN' else nn.BatchNorm2d
        layer = cls(features, eps=cfg.pop('eps', 1e-5),
                    momentum=cfg.pop('momentum', 0.1))
    elif kind == 'GN':
        layer = nn.GroupNorm(cfg.pop('num_groups', 32), features,
                             eps=cfg.pop('eps', 1e-5))
    elif kind == 'LN':
        layer = ChannelLayerNorm(features, eps=cfg.pop('eps', 1e-6))
    elif kind == 'IN':
        layer = nn.GroupNorm(features, features, eps=cfg.pop('eps', 1e-5))
    elif kind in ('none', None):
        return nn.Identity()
    else:
        raise ValueError(f'unsupported norm type {kind}')
    for p in layer.parameters():
        p.requires_grad_(requires_grad)
    return layer


class NormEvalModule(nn.Module):
    """A backbone with ``norm_eval``: its batch norms stay in eval mode
    while it trains, as the JAX files run them on running statistics."""

    norm_eval = False

    def train(self, mode: bool = True):
        super().train(mode)
        if mode and self.norm_eval:
            for m in self.modules():
                if isinstance(m, nn.modules.batchnorm._BatchNorm):
                    m.eval()
        return self


def build_act(act_cfg: Optional[dict]) -> Optional[Callable]:
    if act_cfg is None:
        return None
    kind = act_cfg.get('type', 'ReLU')
    table = {
        'ReLU': F.relu,
        'ReLU6': F.relu6,
        # flax's nn.gelu is the tanh approximation
        'GELU': lambda x: F.gelu(x, approximate='tanh'),
        'SiLU': F.silu,
        'Swish': F.silu,
        'Sigmoid': torch.sigmoid,
        'Tanh': torch.tanh,
        'LeakyReLU': lambda x: F.leaky_relu(
            x, negative_slope=act_cfg.get('negative_slope', 0.01)),
        'HSwish': F.hardswish,
        'HSigmoid': F.hardsigmoid,
    }
    if kind not in table:
        raise ValueError(f'unsupported act type {kind}')
    return table[kind]


class ConvModule(nn.Module):
    """conv (+ norm) (+ act), NCHW. mmcv ``ConvModule`` equivalent."""

    def __init__(self,
                 in_channels: int,
                 out_channels: int,
                 kernel_size: Union[int, Tuple[int, int]] = 3,
                 stride: Union[int, Tuple[int, int]] = 1,
                 padding: Union[int, Tuple[int, int], str] = 0,
                 dilation: Union[int, Tuple[int, int]] = 1,
                 groups: int = 1,
                 bias: Union[bool, str] = 'auto',
                 norm_cfg: Optional[dict] = None,
                 act_cfg: Optional[dict] = None,
                 order: Tuple[str, ...] = ('conv', 'norm', 'act')):
        super().__init__()
        with_norm = norm_cfg is not None
        use_bias = (not with_norm) if bias == 'auto' else bool(bias)
        if isinstance(padding, str):
            padding = padding.lower()
        self.conv = nn.Conv2d(in_channels, out_channels,
                              _pair(kernel_size), _pair(stride),
                              padding if isinstance(padding, str)
                              else _pair(padding), _pair(dilation),
                              groups=groups, bias=use_bias)
        self.norm_name = norm_name(norm_cfg) if with_norm else None
        if with_norm:
            # a norm placed before the conv normalizes its input
            norm_ch = out_channels if order.index('norm') > \
                order.index('conv') else in_channels
            self.add_module(self.norm_name, Norm(norm_ch, norm_cfg))
        # act_cfg semantics (mmcv): None -> default ReLU; explicit dict
        # overrides; dict(type='none') disables activation.
        if hasattr(act_cfg, 'get') and act_cfg.get('type') in ('none', None):
            self.act = None
        else:
            self.act = build_act(act_cfg if act_cfg is not None
                                 else {'type': 'ReLU'})
        self.order = tuple(order)

    def forward(self, x):
        for layer in self.order:
            if layer == 'conv':
                x = self.conv(x)
            elif layer == 'norm' and self.norm_name is not None:
                x = getattr(self, self.norm_name)(x)
            elif layer == 'act' and self.act is not None:
                x = self.act(x)
        return x


class DepthwiseSeparableConvModule(nn.Module):
    """depthwise k x k (+norm+act) then pointwise 1x1 (+norm+act)."""

    def __init__(self,
                 in_channels: int,
                 out_channels: int,
                 kernel_size: Union[int, Tuple[int, int]] = 3,
                 stride: Union[int, Tuple[int, int]] = 1,
                 padding: Union[int, Tuple[int, int]] = 0,
                 dilation: Union[int, Tuple[int, int]] = 1,
                 norm_cfg: Optional[dict] = None,
                 act_cfg: Optional[dict] = None):
        super().__init__()
        self.depthwise_conv = ConvModule(
            in_channels, in_channels, kernel_size, stride=stride,
            padding=padding, dilation=dilation, groups=in_channels,
            norm_cfg=norm_cfg, act_cfg=act_cfg)
        self.pointwise_conv = ConvModule(
            in_channels, out_channels, 1, norm_cfg=norm_cfg,
            act_cfg=act_cfg)

    def forward(self, x):
        return self.pointwise_conv(self.depthwise_conv(x))
