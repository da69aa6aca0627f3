"""Resize ops on NCHW tensors (port of ``pfst_tpu/ops/resize.py``).

The JAX file reproduces ``torch.nn.functional.interpolate``'s sampling
(``rsiseg/ops/wrappers.py:8-27``); here the torch call is the op itself.
The output size is always computed first and passed as ``size``, so the
sampling grid is the one the JAX file uses for both ``size`` and
``scale_factor`` callers:

* bilinear ``align_corners=False``: half-pixel centers with edge clamp;
* bilinear ``align_corners=True``: ``src = dst * (S - 1) / (D - 1)``;
* nearest: torch's legacy asymmetric rule ``src = floor(dst * S / D)``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F


def _out_size(in_size: Tuple[int, int],
              size: Optional[Sequence[int]],
              scale_factor: Optional[Union[float, Sequence[float]]]):
    if size is not None:
        return (int(size[0]), int(size[1]))
    if scale_factor is None:
        raise ValueError('either size or scale_factor must be given')
    if isinstance(scale_factor, (int, float)):
        scale_factor = (scale_factor, scale_factor)
    return (int(in_size[0] * scale_factor[0]),
            int(in_size[1] * scale_factor[1]))


def resize(x: torch.Tensor,
           size: Optional[Sequence[int]] = None,
           scale_factor: Optional[Union[float, Sequence[float]]] = None,
           mode: str = 'bilinear',
           align_corners: Optional[bool] = None,
           warning: bool = False) -> torch.Tensor:
    """Resize NCHW (or CHW) ``x`` to ``size=(H, W)``."""
    del warning
    squeeze = x.ndim == 3
    if squeeze:
        x = x[None]
    if x.ndim != 4:
        raise ValueError(f'expected NCHW input, got shape {tuple(x.shape)}')
    out_hw = _out_size(tuple(x.shape[2:]), size, scale_factor)
    if out_hw == tuple(x.shape[2:]):
        out = x
    elif mode == 'nearest':
        out = F.interpolate(x, size=out_hw, mode='nearest')
    elif mode == 'bilinear':
        out = F.interpolate(x, size=out_hw, mode='bilinear',
                            align_corners=bool(align_corners))
    else:
        raise ValueError(f'unsupported mode {mode}')
    return out[0] if squeeze else out


def adaptive_avg_pool_1x1(x: torch.Tensor) -> torch.Tensor:
    """Global average pool to 1x1, NCHW."""
    return x.mean(dim=(2, 3), keepdim=True)
