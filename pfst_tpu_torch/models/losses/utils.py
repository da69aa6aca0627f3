"""Loss reduction helpers (port of ``pfst_tpu/models/losses/utils.py``).

The eps guards are the JAX file's: a mean with ``avg_factor`` divides by
``avg_factor + eps``, ``masked_mean`` by ``sum(mask) + eps`` and
``masked_std`` by ``max(n - 1, 1e-6)``, with eps the float32 epsilon.
"""
from __future__ import annotations

import json
from typing import Optional

import numpy as np
import torch

_EPS = float(np.finfo(np.float32).eps)


def get_class_weight(class_weight):
    """Per-class weights from a list, a ``.npy`` file or a JSON file."""
    if isinstance(class_weight, str):
        if class_weight.endswith('.npy'):
            return np.load(class_weight)
        with open(class_weight) as f:
            return json.load(f)
    return class_weight


def reduce_loss(loss: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == 'none':
        return loss
    if reduction == 'mean':
        return loss.mean()
    if reduction == 'sum':
        return loss.sum()
    raise ValueError(f'invalid reduction {reduction}')


def weight_reduce_loss(loss: torch.Tensor,
                       weight: Optional[torch.Tensor] = None,
                       reduction: str = 'mean',
                       avg_factor=None) -> torch.Tensor:
    """Elementwise ``weight``, then reduce; with ``avg_factor`` a mean is
    ``sum / (avg_factor + eps)`` (``losses/utils.py:34-52``)."""
    if weight is not None:
        loss = loss * weight
    if avg_factor is None:
        return reduce_loss(loss, reduction)
    if reduction == 'mean':
        return loss.sum() / (avg_factor + _EPS)
    if reduction == 'none':
        return loss
    raise ValueError('avg_factor can not be used with reduction="sum"')


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of ``x`` over ``mask`` (eps-guarded)."""
    m = mask.to(x.dtype)
    return (x * m).sum() / (m.sum() + _EPS)


def masked_std(x: torch.Tensor, mask: torch.Tensor,
               unbiased: bool = True) -> torch.Tensor:
    """Std of ``x`` over ``mask``, unbiased like torch's ``.std()``."""
    m = mask.to(x.dtype)
    n = m.sum()
    mean = (x * m).sum() / (n + _EPS)
    var = (m * (x - mean)**2).sum() / torch.clamp(
        n - (1.0 if unbiased else 0.0), min=1e-6)
    return torch.sqrt(var)
