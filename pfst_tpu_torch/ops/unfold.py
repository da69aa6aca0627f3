"""Dilated k x k neighborhood extraction on NCHW tensors (port of
``pfst_tpu/ops/unfold.py``, the ``nn.Unfold`` equivalent of
``rsiseg/models/losses/pfgst_loss.py:29-31``).

Neighbors come as ``k*k`` shifted slices of a zero-padded map, in
row-major window order, so index ``(k*k)//2`` is the center pixel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def unfold_neighbors(x: torch.Tensor, kernel_size: int,
                     dilation: int = 1) -> torch.Tensor:
    """(B, C, H, W) -> (B, k*k, C, H, W) neighbor features, zero padded
    by ``(k//2)*dilation`` at the borders."""
    if kernel_size % 2 != 1:
        raise ValueError('kernel_size must be odd')
    h, w = x.shape[2:]
    pad = (kernel_size // 2) * dilation
    xp = F.pad(x, (pad, pad, pad, pad))
    views = [xp[:, :, i * dilation:i * dilation + h,
                j * dilation:j * dilation + w]
             for i in range(kernel_size) for j in range(kernel_size)]
    return torch.stack(views, dim=1)


def unfold_valid_mask(h: int, w: int, kernel_size: int,
                      dilation: int = 1,
                      device=None) -> torch.Tensor:
    """(k*k, H, W) bool mask: True where the neighbor lies inside the map
    (the padded neighbors of ``nn.Unfold`` carry value 0)."""
    pad = (kernel_size // 2) * dilation
    offs = torch.arange(kernel_size, device=device) * dilation - pad
    oy = offs.repeat_interleave(kernel_size)[:, None, None]
    ox = offs.repeat(kernel_size)[:, None, None]
    yy = torch.arange(h, device=device)[None, :, None] + oy
    xx = torch.arange(w, device=device)[None, None, :] + ox
    return (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
