"""Twins backbones, PCPVT and SVT, on NCHW images (port of
``pfst_tpu/models/backbones/twins.py``).

PCPVT: a pyramid of stages, each a stride-p patch embedding and its
LayerNorm, then blocks of global subsampled attention (MiT's
``EfficientAttention``) and Mix-FFN (``mit.MixFFN``, which the JAX file
imports from its MiT too), with a conditional position encoding (``PEG``,
a 3x3 depthwise residual) after the first block of each stage; the
stages' outputs, not normed, are the taps. SVT alternates locally-grouped
attention (``LocalAttention``, even blocks) with the global one.

The patch embedding is a flax ``nn.Conv`` with its default
``padding='SAME'``, as is the global attention's stride-``sr`` conv: both
pad the grid where it is no multiple of their stride, and this module
follows them. ``LocalAttention`` pads the grid to a multiple of its
window, ``min(window, h, w)``, and attends within each window of ws^2
tokens (49 at the full window) through ``ops.attention``; like the JAX
file it does not mask the padded tokens, which mmseg's LSA does (their
zeros take part in the softmax of the windows on the grid's edge).

The JAX tool has no Twins key map (``tools/model_converters/
twins2mmseg.py``), so the module names are the JAX file's:
``patch_embed{i}``, ``embed_norm{i}``, ``s{i}_b{j}.{norm1,attn,norm2,ffn}``
and ``peg{i}.proj``; inside ``attn`` and ``ffn`` the names are those of
``mit.py`` (``attn.attn.in_proj_*``, ``attn.attn.out_proj``, ``attn.sr``,
``attn.norm``, ``ffn.layers.{0,1,4}``), and ``LocalAttention``'s ``qkv``
and ``proj``. LayerNorms use flax's eps 1e-6. Drop path and ``with_cp``
work as in ``beit.py``; ``norm_cfg`` is accepted and unused, as in the
JAX file.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops import attention
from ..builder import BACKBONES
from ..utils.layers import pad_same
from .beit import drop_path, drop_path_masks
from .mit import (EfficientAttention, MixFFN, init_flax, map_to_tokens,
                  tokens_to_map)
from .swin import window_partition, window_reverse
from .vit import _LN_EPS, run_block


class PEG(nn.Module):
    """Conditional position encoding (``twins.py:21-35``): the tokens plus
    a 3x3 depthwise conv of their map."""

    def __init__(self, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(dim, dim, 3, padding=1, groups=dim)

    def forward(self, seq, hw):
        return seq + map_to_tokens(self.proj(tokens_to_map(seq, hw)))


class LocalAttention(nn.Module):
    """Locally-grouped self-attention (``twins.py:38-71``): the grid padded
    to a multiple of ws = min(window, h, w), attention within each ws x ws
    window, the padding cropped."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 7):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = window_size
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)

    def forward(self, seq, hw):
        h, w = hw
        b, n, c = seq.shape
        ws = min(self.window_size, h, w)
        pad_h, pad_w = (ws - h % ws) % ws, (ws - w % ws) % ws
        x = F.pad(seq.reshape(b, h, w, c), (0, 0, 0, pad_w, 0, pad_h))
        x = window_partition(x, ws)                       # (B nw, ws^2, C)
        hd = c // self.num_heads
        q, k, v = self.qkv(x).reshape(-1, ws * ws, 3, self.num_heads,
                                      hd).permute(2, 0, 3, 1, 4).unbind(0)
        o = attention(q, k, v, hd**-0.5)
        o = self.proj(o.transpose(1, 2).reshape(-1, ws * ws, c))
        o = window_reverse(o, ws, h + pad_h, w + pad_w)
        return o[:, :h, :w].reshape(b, n, c)


class TwinsBlock(nn.Module):
    """(``twins.py:74-106``) pre-norm attention (local with a window, else
    global) and Mix-FFN, each residual through drop path."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int = 1,
                 window_size: int = 0, mlp_ratio: int = 4,
                 drop_path_rate: float = 0.0):
        super().__init__()
        self.drop_path_rate = drop_path_rate
        self.norm1 = nn.LayerNorm(dim, eps=_LN_EPS)
        self.attn = LocalAttention(dim, num_heads, window_size) \
            if window_size > 0 else EfficientAttention(dim, num_heads,
                                                       sr_ratio)
        self.norm2 = nn.LayerNorm(dim, eps=_LN_EPS)
        self.ffn = MixFFN(dim, mlp_ratio)

    def forward(self, seq, hw, keep=None):
        keep = (None, None) if keep is None else keep
        seq = seq + drop_path(self.attn(self.norm1(seq), hw), keep[0],
                              self.drop_path_rate)
        return seq + drop_path(self.ffn(self.norm2(seq), hw), keep[1],
                               self.drop_path_rate)


@BACKBONES.register_module()
class PCPVT(nn.Module):
    """(``twins.py:109-166``) Returns the ``out_indices`` stages as (B, C,
    H, W) maps."""

    key_family = 'twins'    # core.convert's key map

    def __init__(self,
                 in_channels: int = 3,
                 embed_dims: Sequence[int] = (64, 128, 320, 512),
                 num_heads: Sequence[int] = (1, 2, 5, 8),
                 depths: Sequence[int] = (3, 4, 6, 3),
                 sr_ratios: Sequence[int] = (8, 4, 2, 1),
                 patch_sizes: Sequence[int] = (4, 2, 2, 2),
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 mlp_ratios: Sequence[int] = (8, 8, 4, 4),
                 windows: Sequence[int] = (0, 0, 0, 0),
                 drop_path_rate: float = 0.0,
                 norm_cfg: Optional[dict] = None,
                 with_cp: bool = False,
                 pretrained: Optional[str] = None,
                 init_cfg: Optional[dict] = None):
        super().__init__()
        del norm_cfg, pretrained, init_cfg
        self.depths = tuple(depths)
        self.patch_sizes = tuple(patch_sizes)
        self.out_indices = tuple(out_indices)
        self.with_cp = with_cp
        self.dpr = [float(r) for r in np.linspace(0, drop_path_rate,
                                                  sum(depths))]
        cin, first = in_channels, 0
        for i, (dim, p) in enumerate(zip(embed_dims, patch_sizes)):
            self.add_module(f'patch_embed{i}', nn.Conv2d(cin, dim, p,
                                                          stride=p))
            self.add_module(f'embed_norm{i}', nn.LayerNorm(dim, eps=_LN_EPS))
            for j in range(depths[i]):
                self.add_module(f's{i}_b{j}', TwinsBlock(
                    dim, num_heads[i], sr_ratios[i],
                    windows[i] if j % 2 == 0 else 0, mlp_ratios[i],
                    self.dpr[first + j]))
            self.add_module(f'peg{i}', PEG(dim))
            cin, first = dim, first + depths[i]

    def init_weights(self, generator: torch.Generator):
        return init_flax(self, generator)

    def forward(self, x):
        masks = iter(drop_path_masks(
            x.shape[0], self.dpr if self.training else [0.0] * len(self.dpr),
            x.device))
        outs = []
        for i, depth in enumerate(self.depths):
            x = getattr(self, f'patch_embed{i}')(
                pad_same(x, self.patch_sizes[i]))
            hw = tuple(x.shape[2:])
            seq = getattr(self, f'embed_norm{i}')(map_to_tokens(x))
            for j in range(depth):
                seq = run_block(getattr(self, f's{i}_b{j}'), self.with_cp,
                                seq, hw, next(masks))
                if j == 0:
                    seq = getattr(self, f'peg{i}')(seq, hw)
            x = tokens_to_map(seq, hw).contiguous()
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)


@BACKBONES.register_module()
class SVT(PCPVT):
    """PCPVT with locally-grouped attention in every even block and the
    JAX file's SVT defaults (``twins.py:169-175``)."""

    def __init__(self, embed_dims: Sequence[int] = (64, 128, 256, 512),
                 num_heads: Sequence[int] = (2, 4, 8, 16),
                 depths: Sequence[int] = (2, 2, 10, 4),
                 mlp_ratios: Sequence[int] = (4, 4, 4, 4),
                 windows: Sequence[int] = (7, 7, 7, 7), **kwargs):
        super().__init__(embed_dims=embed_dims, num_heads=num_heads,
                         depths=depths, mlp_ratios=mlp_ratios,
                         windows=windows, **kwargs)
