"""MixVisionTransformer (SegFormer's MiT backbone) on NCHW images (port of
``pfst_tpu/models/backbones/mit.py``).

Overlapping patch embeddings (a stride-s conv padded by p // 2), blocks
of spatial-reduction attention and Mix-FFN, and a LayerNorm at the end of
each stage; the stages' normed maps are the taps. Inside the backbone
the tokens are (B, h*w, C), as in the JAX file.

Attention goes through ``ops.attention`` with keys shorter than the
queries: a stride-``sr`` convolution (``sr``, then the LayerNorm
``norm``) shortens the grid the keys and values come from, N_k = N_q /
sr^2 (16^2 at every stage of a 512^2 crop), so on the card it runs the
flash kernels with N_k != N_q where the JAX file runs an XLA einsum. The
JAX file's ``sr`` is a flax ``nn.Conv`` with its default
``padding='SAME'``: where h or w is no multiple of ``sr`` it pads the
grid (XLA's split: the smaller half before), where mmseg's (padding 0)
would drop the last rows; this module follows the JAX file. Mix-FFN is
fc1, a 3x3 depthwise conv, exact GELU and fc2, on channels-last maps.

Module names give the mmseg keys that
``tools/convert_torch_checkpoint.py:449-515`` maps:
``layers.{i}.0.projection`` and ``.norm`` (the patch embedding),
``layers.{i}.1.{j}.norm1/norm2``, ``layers.{i}.1.{j}.attn.attn.in_proj_*``
(q|k|v stacked, as ``nn.MultiheadAttention`` holds them),
``attn.attn.out_proj``, ``attn.sr``, ``attn.norm``,
``ffn.layers.{0,1,4}`` (fc1 and fc2 as 1x1 convs) and ``layers.{i}.2``
(the stage norm), so an mmseg SegFormer checkpoint loads as it is.
LayerNorms use flax's eps 1e-6. Drop path and ``with_cp`` work as in
``beit.py``; ``drop_rate``, ``attn_drop_rate`` and ``norm_cfg`` are
accepted and unused, as in the JAX file.
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
from .vit import _LN_EPS, _InOutProj, run_block


def tokens_to_map(seq: torch.Tensor, hw) -> torch.Tensor:
    """(B, h*w, C) tokens as a (B, C, h, w) map in channels-last memory
    (no copy)."""
    b, _, c = seq.shape
    return seq.reshape(b, *hw, c).permute(0, 3, 1, 2)


def map_to_tokens(x: torch.Tensor) -> torch.Tensor:
    """(B, C, h, w) -> (B, h*w, C) tokens."""
    return x.permute(0, 2, 3, 1).flatten(1, 2)


class EfficientAttention(nn.Module):
    """Spatial-reduction attention (``mit.py:22-62``): q from every token,
    k and v from the grid after the stride-``sr`` conv and its norm."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int = 1):
        super().__init__()
        self.num_heads = num_heads
        self.sr_ratio = sr_ratio
        self.attn = _InOutProj(dim)
        if sr_ratio > 1:
            self.sr = nn.Conv2d(dim, dim, sr_ratio, stride=sr_ratio)
            self.norm = nn.LayerNorm(dim, eps=_LN_EPS)

    def forward(self, x, hw):
        b, n, c = x.shape
        hd = c // self.num_heads
        w, bias = self.attn.in_proj_weight, self.attn.in_proj_bias
        kv_in = x
        if self.sr_ratio > 1:
            kv_in = self.norm(map_to_tokens(self.sr(pad_same(
                tokens_to_map(x, hw), self.sr_ratio))))
        # (B, heads, N, hd) and (B, heads, N_k, hd) views of the projections;
        # the kernels read them through their strides
        q = F.linear(x, w[:c], bias[:c]).reshape(
            b, n, self.num_heads, hd).transpose(1, 2)
        k, v = F.linear(kv_in, w[c:], bias[c:]).reshape(
            b, -1, 2, self.num_heads, hd).permute(2, 0, 3, 1, 4).unbind(0)
        o = attention(q, k, v, hd**-0.5)
        return self.attn.out_proj(o.transpose(1, 2).reshape(b, n, c))


class MixFFN(nn.Module):
    """fc1, 3x3 depthwise conv, exact GELU, fc2 (``mit.py:65-80``) under
    mmseg's ``layers.{0,1,4}`` (1x1 convs for fc1 and fc2, applied to the
    tokens as linears)."""

    def __init__(self, dim: int, expansion: int = 4):
        super().__init__()
        hidden = dim * expansion
        self.layers = nn.Sequential(
            nn.Conv2d(dim, hidden, 1),
            nn.Conv2d(hidden, hidden, 3, padding=1, groups=hidden),
            nn.GELU(), nn.Identity(), nn.Conv2d(hidden, dim, 1))

    def forward(self, x, hw):
        fc1, dw, act, _, fc2 = self.layers
        x = F.linear(x, fc1.weight.flatten(1), fc1.bias)
        x = act(map_to_tokens(dw(tokens_to_map(x, hw))))
        return F.linear(x, fc2.weight.flatten(1), fc2.bias)


class MiTBlock(nn.Module):
    """(``mit.py:83-108``) pre-norm attention and Mix-FFN, each residual
    through drop path."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int,
                 mlp_ratio: int = 4, drop_path_rate: float = 0.0):
        super().__init__()
        self.drop_path_rate = drop_path_rate
        self.norm1 = nn.LayerNorm(dim, eps=_LN_EPS)
        self.attn = EfficientAttention(dim, num_heads, sr_ratio)
        self.norm2 = nn.LayerNorm(dim, eps=_LN_EPS)
        self.ffn = MixFFN(dim, mlp_ratio)

    def forward(self, x, hw, keep=None):
        keep = (None, None) if keep is None else keep
        x = x + drop_path(self.attn(self.norm1(x), hw), keep[0],
                          self.drop_path_rate)
        return x + drop_path(self.ffn(self.norm2(x), hw), keep[1],
                             self.drop_path_rate)


class MiTPatchEmbed(nn.Module):

    def __init__(self, in_channels: int, dim: int, patch_size: int,
                 stride: int):
        super().__init__()
        self.projection = nn.Conv2d(in_channels, dim, patch_size,
                                    stride=stride, padding=patch_size // 2)
        self.norm = nn.LayerNorm(dim, eps=_LN_EPS)

    def forward(self, x):
        x = self.projection(x)
        return self.norm(map_to_tokens(x)), x.shape[2:]


def init_flax(module: nn.Module, generator: torch.Generator):
    """flax's default initializers (lecun-normal kernels, zero biases,
    LayerNorms at 1 and 0) on every Dense and Conv of ``module``."""
    from ..utils.layers import init_flax_defaults_
    with torch.no_grad():
        init_flax_defaults_(module, generator)
    return module


@BACKBONES.register_module()
class MixVisionTransformer(nn.Module):
    """(``mit.py:111-167``) Returns the ``out_indices`` stages through
    their norms as (B, C, H, W) maps."""

    key_family = 'mit'      # core.convert's key map

    def __init__(self,
                 in_channels: int = 3,
                 embed_dims: int = 32,
                 num_stages: int = 4,
                 num_layers: Sequence[int] = (2, 2, 2, 2),
                 num_heads: Sequence[int] = (1, 2, 5, 8),
                 patch_sizes: Sequence[int] = (7, 3, 3, 3),
                 strides: Sequence[int] = (4, 2, 2, 2),
                 sr_ratios: Sequence[int] = (8, 4, 2, 1),
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 mlp_ratio: int = 4,
                 drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0,
                 norm_cfg: Optional[dict] = None,
                 with_cp: bool = False,
                 pretrained: Optional[str] = None,
                 init_cfg: Optional[dict] = None):
        super().__init__()
        del drop_rate, attn_drop_rate, norm_cfg, pretrained, init_cfg
        self.out_indices = tuple(out_indices)
        self.with_cp = with_cp
        self.dpr = [float(r) for r in np.linspace(
            0, drop_path_rate, sum(num_layers[:num_stages]))]
        layers, first, cin = [], 0, in_channels
        for i in range(num_stages):
            dim = embed_dims * num_heads[i]
            blocks = [MiTBlock(dim, num_heads[i], sr_ratios[i], mlp_ratio,
                               self.dpr[first + j])
                      for j in range(num_layers[i])]
            layers.append(nn.ModuleList([
                MiTPatchEmbed(cin, dim, patch_sizes[i], strides[i]),
                nn.ModuleList(blocks), nn.LayerNorm(dim, eps=_LN_EPS)]))
            first, cin = first + num_layers[i], dim
        self.layers = nn.ModuleList(layers)

    def init_weights(self, generator: torch.Generator):
        return init_flax(self, generator)

    def forward(self, x):
        masks = iter(drop_path_masks(
            x.shape[0], self.dpr if self.training else [0.0] * len(self.dpr),
            x.device))
        outs = []
        for i, (embed, blocks, norm) in enumerate(self.layers):
            seq, hw = embed(x)
            for blk in blocks:
                seq = run_block(blk, self.with_cp, seq, tuple(hw),
                                next(masks))
            x = tokens_to_map(norm(seq), hw).contiguous()
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)


@BACKBONES.register_module(name='MiT')
class MiT(MixVisionTransformer):
    """The alias some configs use."""
