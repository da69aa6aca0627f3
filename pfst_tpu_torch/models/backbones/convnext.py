"""ConvNeXt backbone on NCHW tensors (port of
``pfst_tpu/models/backbones/convnext.py``, the counterpart of the mmcls
``ConvNeXt`` of ``configs/_base_/models/upernet_convnext.py``).

A 4x4/4 patchify stem and its LayerNorm; per stage, a LayerNorm and a
2x2/2 downsample conv (but the first), then blocks of a 7x7 depthwise
conv, LayerNorm, a 4x expanding Dense, exact GELU, a projecting Dense,
the layer scale ``gamma`` and drop path around a residual; a LayerNorm on
each output. As in the JAX file the stem and downsample convs are flax
``nn.Conv``s with their default ``padding='SAME'``: where H or W is no
multiple of the stride they pad (``pad_same``); the depthwise conv pads 3
a side. LayerNorms are over channels with flax's eps 1e-6; a block runs
its norm and Dense layers channels-last, as the JAX file does. Drop path
draws its per-sample masks up front on the CPU (``beit.drop_path_masks``),
so the card and the CPU drop the same samples. Module names are the JAX
file's (``stem_conv``, ``stem_norm``, ``down_norm{i}``,
``down_conv{i}``, ``stage{i}_block{j}.{dwconv,norm,pwconv1,pwconv2,
gamma}``, ``out_norm{i}``), mapped by ``core.convert``'s ``cnn`` family.
``frozen_stages`` and ``gap_before_final_norm`` are accepted and unused,
as in the JAX file.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..builder import BACKBONES
from ..utils.layers import ChannelLayerNorm, pad_same
from .beit import drop_path, drop_path_masks
from .mit import init_flax

ARCH = {
    'tiny': dict(depths=(3, 3, 9, 3), dims=(96, 192, 384, 768)),
    'small': dict(depths=(3, 3, 27, 3), dims=(96, 192, 384, 768)),
    'base': dict(depths=(3, 3, 27, 3), dims=(128, 256, 512, 1024)),
    'large': dict(depths=(3, 3, 27, 3), dims=(192, 384, 768, 1536)),
    'xlarge': dict(depths=(3, 3, 27, 3), dims=(256, 512, 1024, 2048)),
}
_LN_EPS = 1e-6


class ConvNeXtBlock(nn.Module):

    def __init__(self, dim: int, layer_scale_init_value: float = 1e-6,
                 drop_path_rate: float = 0.0):
        super().__init__()
        self.drop_path_rate = drop_path_rate
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=_LN_EPS)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.full(
            (dim,), float(layer_scale_init_value))) \
            if layer_scale_init_value > 0 else None

    def forward(self, x, keep: Optional[torch.Tensor] = None):
        y = self.dwconv(x).permute(0, 2, 3, 1)
        y = self.pwconv2(F.gelu(self.pwconv1(self.norm(y))))
        if self.gamma is not None:
            y = y * self.gamma
        return x + drop_path(y.permute(0, 3, 1, 2), keep,
                             self.drop_path_rate)


@BACKBONES.register_module()
class ConvNeXt(nn.Module):
    """Returns the feature pyramid at ``out_indices``."""

    key_family = 'cnn'      # core.convert's key map

    def __init__(self,
                 arch: Union[str, dict] = 'tiny',
                 in_channels: int = 3,
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 drop_path_rate: float = 0.0,
                 layer_scale_init_value: float = 1e-6,
                 frozen_stages: int = -1,
                 gap_before_final_norm: bool = False,
                 init_cfg: Optional[dict] = None):
        super().__init__()
        del frozen_stages, gap_before_final_norm, init_cfg
        spec = ARCH[arch] if isinstance(arch, str) else dict(arch)
        self.depths, dims = tuple(spec['depths']), tuple(spec['dims'])
        self.out_indices = tuple(out_indices)
        total = sum(self.depths)
        self.dpr = [drop_path_rate * i / max(total - 1, 1)
                    for i in range(total)]
        cur = 0
        for i, (depth, dim) in enumerate(zip(self.depths, dims)):
            if i == 0:
                self.stem_conv = nn.Conv2d(in_channels, dim, 4, stride=4)
                self.stem_norm = ChannelLayerNorm(dim, _LN_EPS)
            else:
                self.add_module(f'down_norm{i}',
                                ChannelLayerNorm(dims[i - 1], _LN_EPS))
                self.add_module(f'down_conv{i}',
                                nn.Conv2d(dims[i - 1], dim, 2, stride=2))
            for j in range(depth):
                self.add_module(f'stage{i}_block{j}', ConvNeXtBlock(
                    dim, layer_scale_init_value, self.dpr[cur + j]))
            cur += depth
            if i in self.out_indices:
                self.add_module(f'out_norm{i}', ChannelLayerNorm(dim,
                                                                 _LN_EPS))
        self.feature_channels = tuple(dims[i] for i in range(len(dims))
                                      if i in self.out_indices)

    def init_weights(self, generator: torch.Generator):
        """flax's default initializers, as the JAX file's ``nn.Conv`` and
        ``nn.Dense`` layers take them; ``gamma`` stays at
        ``layer_scale_init_value``."""
        return init_flax(self, generator)

    def forward(self, x):
        masks = iter(drop_path_masks(
            x.shape[0], self.dpr if self.training else [0.0] * len(self.dpr),
            x.device))
        outs = []
        for i, depth in enumerate(self.depths):
            if i == 0:
                x = self.stem_norm(self.stem_conv(pad_same(x, 4)))
            else:
                x = getattr(self, f'down_norm{i}')(x)
                x = getattr(self, f'down_conv{i}')(pad_same(x, 2))
            for j in range(depth):
                keep = next(masks)
                x = getattr(self, f'stage{i}_block{j}')(
                    x, None if keep is None else keep[0])
            if i in self.out_indices:
                outs.append(getattr(self, f'out_norm{i}')(x))
        return tuple(outs)
