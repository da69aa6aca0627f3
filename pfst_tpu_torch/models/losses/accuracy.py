"""Pixel accuracy (port of ``pfst_tpu/models/losses/accuracy.py``).

A percentage in [0, 100] with the JAX file's eps guards, so an
all-ignored image gives a finite value.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

_EPS = float(np.finfo(np.float32).eps)


def accuracy(pred: torch.Tensor, target: torch.Tensor, topk: int = 1,
             thresh: Optional[float] = None,
             ignore_index: Optional[int] = None) -> torch.Tensor:
    """Top-k pixel accuracy. ``pred`` (B, C, H, W) logits, ``target``
    (B, H, W)."""
    if pred.ndim != target.ndim + 1:
        raise ValueError(f'pred {tuple(pred.shape)} and target '
                         f'{tuple(target.shape)} do not match')
    if topk == 1:
        correct = pred.argmax(dim=1) == target
        if thresh is not None:
            correct = correct & (pred.amax(dim=1) > thresh)
    else:
        idx = pred.topk(topk, dim=1).indices
        correct = (idx == target[:, None]).any(dim=1)
    if ignore_index is not None:
        valid = target != ignore_index
        correct = correct & valid
        total = valid.float().sum() + _EPS
    else:
        total = float(np.prod(target.shape)) + _EPS
    correct_k = correct.float().sum() + _EPS
    return correct_k * (100.0 / total)
