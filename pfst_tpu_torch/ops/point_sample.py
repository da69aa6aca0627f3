"""Point sampling at normalized coordinates on NCHW maps (port of
``pfst_tpu/ops/point_sample.py``, mmcv's ``point_sample``).

``point_sample(feat, coords)`` reads (B, C, H, W) features at (B, N, 2)
coordinates in [0, 1] x [0, 1], x (the width) first, and returns (B, N,
C):

* bilinear: ``F.grid_sample`` on ``2 * coords - 1`` with zeros outside
  the image, the JAX file's four masked gathers (``:39-54``);
* nearest: the pixel at ``round(x * W - 0.5)`` (``x * (W - 1)`` with
  ``align_corners``), rounded half to even as ``jnp.round`` rounds, and
  clamped into the image (``:34-37``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def point_sample(feat: torch.Tensor, coords: torch.Tensor,
                 mode: str = 'bilinear',
                 align_corners: bool = False) -> torch.Tensor:
    """``feat`` (B, C, H, W), ``coords`` (B, N, 2) in [0, 1] (x, y) ->
    (B, N, C)."""
    b, c, h, w = feat.shape
    if mode == 'bilinear':
        grid = (2.0 * coords - 1.0)[:, :, None, :].to(feat.dtype)
        out = F.grid_sample(feat, grid, mode='bilinear', padding_mode='zeros',
                            align_corners=align_corners)
        return out[..., 0].transpose(1, 2)
    if mode != 'nearest':
        raise ValueError(f'unsupported mode {mode}')
    x, y = coords[..., 0], coords[..., 1]
    if align_corners:
        xu, yu = x * (w - 1), y * (h - 1)
    else:
        xu, yu = x * w - 0.5, y * h - 0.5
    xi = torch.round(xu).clamp(0, w - 1).long()
    yi = torch.round(yu).clamp(0, h - 1).long()
    idx = (yi * w + xi)[:, None, :].expand(-1, c, -1)
    return feat.flatten(2).gather(2, idx).transpose(1, 2)
