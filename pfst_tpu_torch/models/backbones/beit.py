"""BEiT and MAE backbones on NCHW images (port of
``pfst_tpu/models/backbones/beit.py``).

The JAX file's architecture: a learned relative-position bias over the
whole ``(Wh*Ww + 1)^2`` token grid, the cls rows included (three extra
table entries: cls -> token, token -> cls, cls -> cls); the q/v-only
learnable bias (k's is a frozen zero); layer scale (``gamma_1``,
``gamma_2`` at ``init_values``); per-sample stochastic depth on both
residual branches with a linear rate schedule. MAE differs by an absolute
``pos_embed`` added after the cls token, zero-initialised tables and no
q/v bias.

Module names give the mmseg keys that
``tools/convert_torch_checkpoint.py:303-349`` maps:
``patch_embed.projection``, ``cls_token``, ``pos_embed``,
``layers.{i}.ln1/ln2``, ``layers.{i}.attn.qkv`` (no bias),
``attn.q_bias`` / ``attn.v_bias``, ``attn.relative_position_bias_table``,
``attn.proj``, ``layers.{i}.gamma_1/gamma_2``,
``layers.{i}.ffn.layers.0.0`` and ``.1``, and ``ln1`` for the final norm.
LayerNorms use flax's eps 1e-6 and the MLP's GELU is exact, as in the
JAX file.

Attention goes through ``ops.attention`` with the table's bias as its
``ab``: the flash kernels on the card, the plain formula on the CPU. The
JAX file adds the bias after the scale, the kernels before it, so the
bias is passed as ``bias / scale`` (exact at d = 64, where the scale is
1/8), one ``(1, H, N, N)`` tensor that every image of the batch reads.

Drop path draws each block's two per-sample masks up front, on the CPU
from the default generator (which the train step seeds from its
generator), so the card and the CPU draw the same masks, and a block
rematerialised by ``with_cp`` (``torch.utils.checkpoint``, the JAX file's
``nn.remat``) gets them as inputs instead of drawing again.
``attn_drop_rate``, ``norm_eval``, ``interpolate_mode`` and the configs'
other keys are accepted and unused, as in the JAX file; the patch grid
must match ``img_size // patch_size`` (the tables are sized by it), else
a ``ValueError`` as there.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops import attention
from ...parallel.global_batch import batch_rows
from ..builder import BACKBONES
from .vit import _LN_EPS, FFN, PatchEmbed, run_block


@lru_cache(maxsize=None)
def relative_position_index(wh: int, ww: int) -> np.ndarray:
    """(Wh*Ww+1, Wh*Ww+1) int index into the bias table, cls token in row
    and column 0 (``beit.py:41-59``)."""
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww),
                                  indexing='ij'))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0).copy()
    rel[..., 0] += wh - 1
    rel[..., 1] += ww - 1
    rel[..., 0] *= 2 * ww - 1
    num_rel = (2 * wh - 1) * (2 * ww - 1) + 3
    idx = np.zeros((wh * ww + 1, wh * ww + 1), np.int64)
    idx[1:, 1:] = rel.sum(-1)
    idx[0, :] = num_rel - 3     # cls -> token
    idx[:, 0] = num_rel - 2     # token -> cls
    idx[0, 0] = num_rel - 1     # cls -> cls
    return idx


def table_bias(table: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """The (heads, N, N) bias that ``table`` (entries, heads) gives through
    the (N, N) ``index``, contiguous."""
    return table.t()[:, index]


def drop_index_buffer(state_dict, prefix):
    """Drop an mmseg checkpoint's persistent ``relative_position_index``
    (the port recomputes it), so such a checkpoint loads as it is."""
    state_dict.pop(prefix + 'relative_position_index', None)


def drop_path_masks(batch: int, rates: Sequence[float], device):
    """Two per-sample keep masks a block, (len(rates), 2, batch) bool on
    ``device`` (None where a rate is 0), drawn with
    ``torch.rand`` on the CPU's default generator (for the global batch,
    this rank's columns kept, in a GSPMD step's split forward)."""
    total, rows = batch_rows(batch)
    out = []
    for rate in rates:
        if rate == 0.0:
            out.append(None)
        else:
            keep = (torch.rand((2, total)) >= rate)[:, rows]
            out.append(keep.to(device, non_blocking=True))
    return out


def drop_path(x: torch.Tensor, keep: Optional[torch.Tensor], rate: float):
    """The JAX file's ``where(mask, x / keep, 0)`` per sample."""
    if keep is None:
        return x
    mask = keep.view((-1,) + (1,) * (x.ndim - 1))
    return torch.where(mask, x / (1.0 - rate), torch.zeros_like(x))


class BEiTAttention(nn.Module):
    """Self-attention with the relative-position bias (``beit.py:72-121``);
    the index is a buffer outside the state dict (an mmseg checkpoint's is
    dropped on load, as the converter drops it)."""

    def __init__(self, embed_dims: int, num_heads: int,
                 window_size: Tuple[int, int], qv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = window_size
        self.qkv = nn.Linear(embed_dims, embed_dims * 3, bias=False)
        if qv_bias:
            self.q_bias = nn.Parameter(torch.zeros(embed_dims))
            self.v_bias = nn.Parameter(torch.zeros(embed_dims))
        else:
            self.q_bias = self.v_bias = None
        wh, ww = window_size
        num_rel = (2 * wh - 1) * (2 * ww - 1) + 3
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros(num_rel, num_heads))
        self.register_buffer('relative_position_index', torch.from_numpy(
            relative_position_index(wh, ww)), persistent=False)
        self.proj = nn.Linear(embed_dims, embed_dims)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        drop_index_buffer(state_dict, prefix)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x):
        b, n, c = x.shape
        wh, ww = self.window_size
        if n != wh * ww + 1:
            raise ValueError(
                f'BEiT sequence length {n} != window {wh}x{ww}+1; set '
                f'img_size so the patch grid matches the input')
        hd = c // self.num_heads
        bias = None
        if self.q_bias is not None:
            bias = torch.cat([self.q_bias, torch.zeros_like(self.q_bias),
                              self.v_bias])
        qkv = F.linear(x, self.qkv.weight, bias)
        q, k, v = qkv.reshape(b, n, 3, self.num_heads, hd).permute(
            2, 0, 3, 1, 4).unbind(0)
        scale = hd**-0.5
        rel = table_bias(self.relative_position_bias_table,
                         self.relative_position_index)
        o = attention(q, k, v, scale, (rel / scale)[None])
        return self.proj(o.transpose(1, 2).reshape(b, n, c))


class BEiTBlock(nn.Module):
    """Pre-norm block with layer scale (``beit.py:124-160``): ``x +=
    DropPath(gamma_1 * attn(ln1(x)))``, then the FFN branch."""

    def __init__(self, embed_dims: int, num_heads: int,
                 window_size: Tuple[int, int], mlp_ratio: int = 4,
                 qv_bias: bool = True, init_values: float = 0.1,
                 drop_path_rate: float = 0.0):
        super().__init__()
        self.drop_path_rate = drop_path_rate
        self.ln1 = nn.LayerNorm(embed_dims, eps=_LN_EPS)
        self.attn = BEiTAttention(embed_dims, num_heads, window_size,
                                  qv_bias)
        self.ln2 = nn.LayerNorm(embed_dims, eps=_LN_EPS)
        self.ffn = FFN(embed_dims, embed_dims * mlp_ratio)
        self.gamma_1 = nn.Parameter(torch.full((embed_dims,), init_values))
        self.gamma_2 = nn.Parameter(torch.full((embed_dims,), init_values))

    def forward(self, x, keep=None):
        keep = (None, None) if keep is None else keep
        rate = self.drop_path_rate
        x = x + drop_path(self.gamma_1 * self.attn(self.ln1(x)), keep[0],
                          rate)
        return x + drop_path(self.gamma_2 * self.ffn(self.ln2(x)), keep[1],
                             rate)


@BACKBONES.register_module()
class BEiT(nn.Module):
    """BERT pre-training of image transformers (``beit.py:163-249``);
    returns the ``out_indices`` taps as (B, C, H/p, W/p) maps."""

    key_family = 'beit'     # core.convert's key map
    abs_pos_embed = False
    rel_pos_zero_init = False

    def __init__(self,
                 img_size: Union[int, Tuple[int, int]] = 224,
                 patch_size: int = 16,
                 in_channels: int = 3,
                 embed_dims: int = 768,
                 num_layers: int = 12,
                 num_heads: int = 12,
                 mlp_ratio: int = 4,
                 out_indices: Union[int, Sequence[int]] = -1,
                 qv_bias: bool = True,
                 attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0,
                 patch_norm: bool = False,
                 final_norm: bool = False,
                 norm_eval: bool = False,
                 init_values: float = 0.1,
                 interpolate_mode: str = 'bicubic',
                 norm_cfg: Optional[dict] = None,
                 act_cfg: Optional[dict] = None,
                 num_fcs: int = 2,
                 with_cp: bool = False,
                 pretrained: Optional[str] = None,
                 init_cfg: Optional[dict] = None):
        super().__init__()
        # accepted for config compatibility and unused, as in the JAX file
        del attn_drop_rate, patch_norm, norm_eval, interpolate_mode
        del norm_cfg, act_cfg, num_fcs, pretrained, init_cfg
        hw = (img_size, img_size) if isinstance(img_size, int) \
            else tuple(img_size)
        self.window_size = (hw[0] // patch_size, hw[1] // patch_size)
        self.num_layers = num_layers
        self.out_indices = ([num_layers - 1 if out_indices == -1
                             else out_indices]
                            if isinstance(out_indices, int)
                            else list(out_indices))
        self.final_norm = final_norm
        self.with_cp = with_cp
        self.dpr = [float(r) for r in np.linspace(0, drop_path_rate,
                                                  num_layers)]
        self.patch_embed = PatchEmbed(in_channels, embed_dims, patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dims))
        wh, ww = self.window_size
        if self.abs_pos_embed:
            self.pos_embed = nn.Parameter(
                torch.zeros(1, wh * ww + 1, embed_dims))
        self.layers = nn.ModuleList(
            BEiTBlock(embed_dims, num_heads, self.window_size, mlp_ratio,
                      qv_bias, init_values, rate)
            for rate in self.dpr)
        if final_norm:
            self.ln1 = nn.LayerNorm(embed_dims, eps=_LN_EPS)

    def init_weights(self, generator: torch.Generator):
        """The JAX file's initializers: Dense kernels and the patch
        embedding lecun-normal with zero bias, LayerNorms at 1 and 0,
        ``cls_token`` and the q/v biases 0, ``gamma_*`` at
        ``init_values`` (kept), the tables truncated-normal(0.02) (MAE:
        0), MAE's ``pos_embed`` truncated-normal(0.02)."""
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
                elif isinstance(m, BEiTAttention):
                    for p in (m.q_bias, m.v_bias):
                        if p is not None:
                            p.zero_()
                    table = m.relative_position_bias_table
                    if self.rel_pos_zero_init:
                        table.zero_()
                    else:
                        nn.init.trunc_normal_(table, 0.0, 0.02, -0.04, 0.04,
                                              generator=generator)
            self.cls_token.zero_()
            if self.abs_pos_embed:
                nn.init.trunc_normal_(self.pos_embed, 0.0, 0.02, -0.04,
                                      0.04, generator=generator)
        return self

    def forward(self, x):
        x = self.patch_embed(x)
        b, c, h, w = x.shape
        if (h, w) != self.window_size:
            raise ValueError(
                f'BEiT patch grid {(h, w)} != window {self.window_size}; the '
                f'relative-position tables are sized by img_size // '
                f'patch_size (reference constraint, beit.py:326-327)')
        seq = torch.cat([self.cls_token.expand(b, -1, -1),
                         x.flatten(2).transpose(1, 2)], dim=1)
        if self.abs_pos_embed:
            seq = seq + self.pos_embed
        masks = drop_path_masks(b, self.dpr if self.training else
                                [0.0] * self.num_layers, seq.device)
        outs = []
        for i, (layer, keep) in enumerate(zip(self.layers, masks)):
            seq = run_block(layer, self.with_cp, seq, keep)
            if i == self.num_layers - 1 and self.final_norm:
                seq = self.ln1(seq)
            if i in self.out_indices:
                outs.append(seq[:, 1:])
        return tuple(y.transpose(1, 2).reshape(b, c, h, w) for y in outs)


@BACKBONES.register_module()
class MAE(BEiT):
    """MAE-pretrained ViT (``beit.py:252-258``): BEiT with an absolute
    ``pos_embed``, zero-initialised tables and no q/v bias."""

    abs_pos_embed = True
    rel_pos_zero_init = True

    def __init__(self, qv_bias: bool = False, **kwargs):
        super().__init__(qv_bias=qv_bias, **kwargs)
