"""Vision Transformer backbone on NCHW images (port of
``pfst_tpu/models/backbones/vit.py``).

Plain ViT with learned position embeddings and per-block output taps for
a pyramid neck. Module names give the rsiseg state-dict keys
(``patch_embed.projection``, ``cls_token``, ``pos_embed``,
``layers.{i}.ln1/ln2``, ``layers.{i}.attn.attn.in_proj_{weight,bias}``,
``layers.{i}.attn.attn.out_proj``, ``layers.{i}.ffn.layers.0.0`` and
``.1``, and ``ln1`` for the final norm), the names
``tools/convert_torch_checkpoint.py:350-395`` maps. LayerNorms use flax's
eps 1e-6 and the MLP's GELU is exact, as in the JAX file. Attention goes
through ``ops.attention``: the flash kernels on the card, the plain
formula on the CPU. Like the JAX file, ``drop_rate`` and ``norm_cfg``
are accepted and unused, and a position-embedding resize supports only
the modes of ``ops.resize`` (no bicubic: it raises, as JAX does).
``with_cp`` rematerialises each block in the backward
(``torch.utils.checkpoint``, the JAX file's ``nn.remat``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ...ops import attention, resize
from ..builder import BACKBONES

_LN_EPS = 1e-6


class _InOutProj(nn.Module):
    """The parameters of ``nn.MultiheadAttention`` under its names:
    ``in_proj_weight`` (3C, C), ``in_proj_bias`` and ``out_proj``."""

    def __init__(self, dim: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)


class MultiheadAttention(nn.Module):
    """Self-attention of one block (mmcv's wrapper, holding ``attn``)."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.attn = _InOutProj(dim)

    def forward(self, x):
        b, n, c = x.shape
        hd = c // self.num_heads
        qkv = F.linear(x, self.attn.in_proj_weight, self.attn.in_proj_bias)
        # (B, N, 3, heads, hd) -> three (B, heads, N, hd) views; the kernels
        # read them through their strides, and write O as the transposed
        # view of a (B, N, heads, hd) tensor, so both reshapes are free
        q, k, v = qkv.reshape(b, n, 3, self.num_heads, hd).permute(
            2, 0, 3, 1, 4).unbind(0)
        o = attention(q, k, v, hd**-0.5)
        return self.attn.out_proj(o.transpose(1, 2).reshape(b, n, c))


class FFN(nn.Module):
    """mmcv's FFN keys: ``layers.0.0`` (fc1 + GELU), ``layers.1`` (fc2)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.layers = nn.Sequential(
            nn.Sequential(nn.Linear(dim, hidden), nn.GELU()),
            nn.Linear(hidden, dim))

    def forward(self, x):
        return self.layers(x)


class ViTBlock(nn.Module):

    def __init__(self, dim: int, num_heads: int, mlp_ratio: int = 4):
        super().__init__()
        self.ln1 = nn.LayerNorm(dim, eps=_LN_EPS)
        self.attn = MultiheadAttention(dim, num_heads)
        self.ln2 = nn.LayerNorm(dim, eps=_LN_EPS)
        self.ffn = FFN(dim, dim * mlp_ratio)

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        return x + self.ffn(self.ln2(x))


def run_block(block: nn.Module, with_cp: bool, x, *args):
    """``block(x, *args)``; with ``with_cp``, while a gradient is taken,
    through ``torch.utils.checkpoint`` (not reentrant): its activations
    are recomputed in the backward instead of kept."""
    if with_cp and torch.is_grad_enabled():
        return checkpoint(block, x, *args, use_reentrant=False)
    return block(x, *args)


class PatchEmbed(nn.Module):

    def __init__(self, in_channels: int, embed_dims: int, patch_size: int):
        super().__init__()
        self.projection = nn.Conv2d(in_channels, embed_dims, patch_size,
                                    stride=patch_size)

    def forward(self, x):
        return self.projection(x)


@BACKBONES.register_module()
class VisionTransformer(nn.Module):
    """Returns the ``out_indices`` taps as (B, C, H/p, W/p) maps, the last
    one through the final LayerNorm when ``final_norm``."""

    def __init__(self,
                 img_size: int = 224,
                 patch_size: int = 16,
                 in_channels: int = 3,
                 embed_dims: int = 768,
                 num_layers: int = 12,
                 num_heads: int = 12,
                 mlp_ratio: int = 4,
                 out_indices: Sequence[int] = (2, 5, 8, 11),
                 with_cls_token: bool = True,
                 output_cls_token: bool = False,
                 interpolate_mode: str = 'bilinear',
                 drop_rate: float = 0.0,
                 norm_cfg: Optional[dict] = None,
                 final_norm: bool = False,
                 with_cp: bool = False,
                 pretrained: Optional[str] = None,
                 init_cfg: Optional[dict] = None):
        super().__init__()
        # output_cls_token, pretrained and init_cfg are accepted for
        # config compatibility and unused, as in the JAX file
        del output_cls_token, drop_rate, norm_cfg, pretrained, init_cfg
        self.with_cp = with_cp
        self.img_size = img_size
        self.patch_size = patch_size
        self.out_indices = tuple(out_indices)
        self.with_cls_token = with_cls_token
        self.interpolate_mode = interpolate_mode
        self.final_norm = final_norm
        n_pre = img_size // patch_size
        self.patch_embed = PatchEmbed(in_channels, embed_dims, patch_size)
        self.pos_embed = nn.Parameter(
            torch.zeros(1, n_pre * n_pre + 1, embed_dims))
        if with_cls_token:
            self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dims))
        self.layers = nn.ModuleList(
            ViTBlock(embed_dims, num_heads, mlp_ratio)
            for _ in range(num_layers))
        if final_norm:
            self.ln1 = nn.LayerNorm(embed_dims, eps=_LN_EPS)

    def init_weights(self, generator: torch.Generator):
        """The JAX file's initializers: Dense kernels and the patch
        embedding lecun-normal with zero bias, LayerNorms at scale 1 and
        bias 0, ``pos_embed`` truncated-normal(0.02), ``cls_token`` 0."""
        from ..utils.layers import init_flax_defaults_
        with torch.no_grad():
            init_flax_defaults_(self, generator)
            nn.init.trunc_normal_(self.pos_embed, 0.0, 0.02, -0.04, 0.04,
                                  generator=generator)
            if self.with_cls_token:
                self.cls_token.zero_()
        return self

    def forward(self, x):
        x = self.patch_embed(x)
        b, c, h, w = x.shape
        seq = x.flatten(2).transpose(1, 2)                 # (B, h*w, C)
        n_pre = self.img_size // self.patch_size
        cls_pos, grid_pos = self.pos_embed[:, :1], self.pos_embed[:, 1:]
        if (h, w) != (n_pre, n_pre):
            grid = grid_pos.reshape(1, n_pre, n_pre, c).permute(0, 3, 1, 2)
            grid = resize(grid, size=(h, w), mode=self.interpolate_mode,
                          align_corners=False)
            grid_pos = grid.flatten(2).transpose(1, 2)
        if self.with_cls_token:
            seq = torch.cat([self.cls_token.expand(b, -1, -1), seq], dim=1)
            seq = seq + torch.cat([cls_pos, grid_pos], dim=1)
        else:
            seq = seq + grid_pos
        outs = []
        for i, layer in enumerate(self.layers):
            seq = run_block(layer, self.with_cp, seq)
            if i in self.out_indices:
                outs.append(seq[:, 1:] if self.with_cls_token else seq)
        if self.final_norm and outs:
            outs[-1] = self.ln1(outs[-1])
        return tuple(y.transpose(1, 2).reshape(b, c, h, w) for y in outs)
