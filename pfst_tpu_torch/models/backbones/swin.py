"""Swin Transformer backbone on NCHW images (port of
``pfst_tpu/models/backbones/swin.py``).

Windowed multi-head attention with shifted windows and a relative
position bias; patch merging between stages. Inside the backbone the
tokens are NHWC, as in the JAX file: each block pads its normed input to
a multiple of the window, rolls it by ``-window // 2`` in every second
block, attends within 7x7 windows (the shifted blocks add the JAX file's
mask of -100 between tokens from different regions), rolls back and
crops. The drop-path schedule spans all blocks.

Module names give the mmseg keys that
``tools/convert_torch_checkpoint.py:394-446`` maps:
``patch_embed.projection`` and ``.norm``,
``stages.{i}.blocks.{j}.norm1/norm2``,
``stages.{i}.blocks.{j}.attn.w_msa.{qkv,proj,relative_position_bias_table}``,
``stages.{i}.blocks.{j}.ffn.layers.0.0`` and ``.1``,
``stages.{i}.downsample.{norm,reduction}`` and ``norm{i}``. mmseg merges
patches at the end of stage i with ``nn.Unfold``, whose channel order
(channel-major, the 2x2 window row-major) this module keeps, so an mmseg
checkpoint loads as it is; the JAX file merges at the start of stage
i + 1 in the official position-major order ([0::2, 0::2], [1::2, 0::2],
[0::2, 1::2], [1::2, 1::2]), and ``core.convert`` permutes between the
two. LayerNorms use flax's eps 1e-6 and the MLP's GELU is exact.

Attention goes through ``ops.attention``: q, k, v are (B * windows,
heads, 49, 32), and ``ab`` is the table's bias over the scale, one
(1, heads, 49, 49) tensor every window reads, or with the shift mask
(B * windows, heads, 49, 49). Drop path and ``with_cp`` work as in
``beit.py``. ``pretrain_img_size``, ``strides``, ``drop_rate``,
``attn_drop_rate`` and ``norm_cfg`` are accepted and unused, as in the
JAX file.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops import attention
from ..builder import BACKBONES
from .beit import drop_index_buffer, drop_path, drop_path_masks, table_bias
from .vit import _LN_EPS, FFN, run_block


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * H/ws * W/ws, ws * ws, C), windows row-major
    within each image."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def window_reverse(windows: torch.Tensor, ws: int, h: int,
                   w: int) -> torch.Tensor:
    b = windows.shape[0] // ((h // ws) * (w // ws))
    x = windows.reshape(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


@lru_cache(maxsize=None)
def relative_position_index(ws: int) -> np.ndarray:
    """(ws^2, ws^2) index into the (2 ws - 1)^2-entry table
    (``swin.py:34-43``)."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing='ij'))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0).copy()
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1).astype(np.int64)


@lru_cache(maxsize=None)
def attn_mask(hp: int, wp: int, ws: int, shift: int) -> np.ndarray:
    """(windows, ws^2, ws^2) fp32: -100 between tokens of the shifted grid
    that come from different regions, else 0 (``swin.py:136-146``)."""
    img_mask = np.zeros((1, hp, wp, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img_mask[:, hs, wsl, :] = cnt
            cnt += 1
    windows = window_partition(torch.from_numpy(img_mask), ws)[..., 0]
    diff = windows[:, None, :] - windows[:, :, None]
    return np.where(diff.numpy() != 0, -100.0, 0.0).astype(np.float32)


class WindowMSA(nn.Module):
    """Window attention with the relative-position bias (``swin.py:46-83``)
    under mmseg's ``w_msa`` names."""

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = window_size
        self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1)**2, num_heads))
        self.register_buffer('relative_position_index', torch.from_numpy(
            relative_position_index(window_size)), persistent=False)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        drop_index_buffer(state_dict, prefix)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        bnw, n, c = x.shape
        hd = c // self.num_heads
        q, k, v = self.qkv(x).reshape(bnw, n, 3, self.num_heads, hd).permute(
            2, 0, 3, 1, 4).unbind(0)
        scale = hd**-0.5
        bias = table_bias(self.relative_position_bias_table,
                          self.relative_position_index)
        if mask is None:
            ab = (bias / scale)[None]
        else:
            nw = mask.shape[0]
            ab = ((bias[None] + mask[:, None]) / scale).expand(
                bnw // nw, nw, self.num_heads, n, n).reshape(
                    bnw, self.num_heads, n, n)
        o = attention(q, k, v, scale, ab)
        return self.proj(o.transpose(1, 2).reshape(bnw, n, c))


class ShiftWindowMSA(nn.Module):
    """mmseg's holder of ``w_msa``."""

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 qkv_bias: bool = True):
        super().__init__()
        self.w_msa = WindowMSA(dim, num_heads, window_size, qkv_bias)

    def forward(self, x, mask=None):
        return self.w_msa(x, mask)


class SwinBlock(nn.Module):
    """(``swin.py:86-133``) on NHWC tokens."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 7,
                 shift: bool = False, mlp_ratio: int = 4,
                 qkv_bias: bool = True, drop_path_rate: float = 0.0):
        super().__init__()
        self.window_size = window_size
        self.shift = window_size // 2 if shift else 0
        self.drop_path_rate = drop_path_rate
        self.norm1 = nn.LayerNorm(dim, eps=_LN_EPS)
        self.attn = ShiftWindowMSA(dim, num_heads, window_size, qkv_bias)
        self.norm2 = nn.LayerNorm(dim, eps=_LN_EPS)
        self.ffn = FFN(dim, dim * mlp_ratio)
        self._masks = {}

    def _mask(self, hp, wp, device):
        key = (hp, wp, device)
        if key not in self._masks:
            self._masks[key] = torch.from_numpy(attn_mask(
                hp, wp, self.window_size, self.shift)).to(device)
        return self._masks[key]

    def forward(self, x, keep=None):
        keep = (None, None) if keep is None else keep
        b, h, w, c = x.shape
        ws, shift = self.window_size, self.shift
        pad_h, pad_w = (ws - h % ws) % ws, (ws - w % ws) % ws
        y = F.pad(self.norm1(x), (0, 0, 0, pad_w, 0, pad_h))
        hp, wp = h + pad_h, w + pad_w
        mask = None
        if shift:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
            mask = self._mask(hp, wp, y.device)
        y = window_reverse(self.attn(window_partition(y, ws), mask), ws, hp,
                           wp)
        if shift:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        x = x + drop_path(y[:, :h, :w], keep[0], self.drop_path_rate)
        return x + drop_path(self.ffn(self.norm2(x)), keep[1],
                             self.drop_path_rate)


class PatchMerging(nn.Module):
    """2x2 patch merging in mmseg's ``nn.Unfold`` channel order (channel
    c, window position kh * 2 + kw at c * 4 + kh * 2 + kw), zero-padded to
    even sides as the JAX file pads, then ``norm`` and ``reduction``."""

    def __init__(self, dim: int, out_dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=_LN_EPS)
        self.reduction = nn.Linear(4 * dim, out_dim, bias=False)

    def forward(self, x):
        b, h, w, c = x.shape
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        h2, w2 = (h + h % 2) // 2, (w + w % 2) // 2
        x = x.reshape(b, h2, 2, w2, 2, c).permute(0, 1, 3, 5, 2, 4).reshape(
            b, h2, w2, 4 * c)
        return self.reduction(self.norm(x))


class SwinBlockSequence(nn.Module):

    def __init__(self, blocks, downsample=None):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample


class SwinPatchEmbed(nn.Module):

    def __init__(self, in_channels: int, embed_dims: int, patch_size: int,
                 patch_norm: bool):
        super().__init__()
        self.projection = nn.Conv2d(in_channels, embed_dims, patch_size,
                                    stride=patch_size)
        self.norm = nn.LayerNorm(embed_dims, eps=_LN_EPS) \
            if patch_norm else None

    def forward(self, x):
        x = self.projection(x).permute(0, 2, 3, 1)
        return x if self.norm is None else self.norm(x)


@BACKBONES.register_module()
class SwinTransformer(nn.Module):
    """(``swin.py:149-222``) Returns the ``out_indices`` stages through
    their norms as (B, C, H, W) maps."""

    key_family = 'swin'     # core.convert's key map

    def __init__(self,
                 pretrain_img_size: int = 224,
                 in_channels: int = 3,
                 embed_dims: int = 96,
                 patch_size: int = 4,
                 window_size: int = 7,
                 mlp_ratio: int = 4,
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 strides: Sequence[int] = (4, 2, 2, 2),
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 qkv_bias: bool = True,
                 drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0,
                 patch_norm: bool = True,
                 norm_cfg: Optional[dict] = None,
                 with_cp: bool = False,
                 pretrained: Optional[str] = None,
                 init_cfg: Optional[dict] = None):
        super().__init__()
        del pretrain_img_size, strides, drop_rate, attn_drop_rate
        del norm_cfg, pretrained, init_cfg
        self.out_indices = tuple(out_indices)
        self.with_cp = with_cp
        self.dpr = [float(r) for r in np.linspace(0, drop_path_rate,
                                                  sum(depths))]
        self.patch_embed = SwinPatchEmbed(in_channels, embed_dims,
                                          patch_size, patch_norm)
        stages, first = [], 0
        for i, depth in enumerate(depths):
            dim = embed_dims * 2**i
            blocks = [SwinBlock(dim, num_heads[i], window_size,
                                shift=bool(j % 2), mlp_ratio=mlp_ratio,
                                qkv_bias=qkv_bias,
                                drop_path_rate=self.dpr[first + j])
                      for j in range(depth)]
            down = PatchMerging(dim, 2 * dim) if i + 1 < len(depths) \
                else None
            stages.append(SwinBlockSequence(blocks, down))
            first += depth
        self.stages = nn.ModuleList(stages)
        for i in self.out_indices:
            self.add_module(f'norm{i}', nn.LayerNorm(embed_dims * 2**i,
                                                     eps=_LN_EPS))

    def init_weights(self, generator: torch.Generator):
        """The JAX file's initializers: Dense kernels and the patch
        embedding lecun-normal with zero bias, LayerNorms at 1 and 0, the
        tables truncated-normal(0.02)."""
        from ..utils.layers import lecun_normal_
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Linear, nn.Conv2d)):
                    lecun_normal_(m.weight, generator)
                    if m.bias is not None:
                        m.bias.zero_()
                elif isinstance(m, nn.LayerNorm):
                    m.weight.fill_(1.0)
                    m.bias.zero_()
                elif isinstance(m, WindowMSA):
                    nn.init.trunc_normal_(m.relative_position_bias_table,
                                          0.0, 0.02, -0.04, 0.04,
                                          generator=generator)
        return self

    def forward(self, x):
        x = self.patch_embed(x)
        blocks = [blk for stage in self.stages for blk in stage.blocks]
        masks = iter(drop_path_masks(
            x.shape[0], self.dpr if self.training else [0.0] * len(blocks),
            x.device))
        outs = []
        for i, stage in enumerate(self.stages):
            for blk in stage.blocks:
                x = run_block(blk, self.with_cp, x, next(masks))
            if i in self.out_indices:
                outs.append(getattr(self, f'norm{i}')(x).permute(
                    0, 3, 1, 2).contiguous())
            if stage.downsample is not None:
                x = stage.downsample(x)
        return tuple(outs)
