"""Entropy minimisation loss (port of
``pfst_tpu/models/losses/entropy_loss.py``; mirrors
``rsiseg/models/losses/entropy_loss.py:13``), on NCHW tensors."""
from __future__ import annotations

import math

import torch

from ..builder import LOSSES


def prob2ent(prob: torch.Tensor) -> torch.Tensor:
    """The per-class normalised entropy map of (B, C, H, W) probabilities:
    ``-p log2(p + 1e-30) / log2(C)`` (``entropy_loss.py:13-17``)."""
    c = prob.shape[1]
    return -prob * torch.log2(prob + 1e-30) / math.log2(c)


@LOSSES.register_module()
class EntropyLoss:
    """``entropy``: the mean over pixels of the summed normalised entropy
    of the target prediction; ``max_square``: minus half the mean squared
    probability (``entropy_loss.py:20-45``). Reads ``logits_trg``."""

    def __init__(self, loss_type='entropy', weights=None, **kwargs):
        if loss_type not in ('entropy', 'max_square'):
            raise ValueError(loss_type)
        self.loss_type = loss_type
        self._loss_name = f'loss_{loss_type}'
        self.weights = weights or {}

    @property
    def loss_name(self):
        return self._loss_name

    def __call__(self, tensors):
        prob = torch.softmax(tensors['logits_trg'].float(), dim=1)
        if self.loss_type == 'entropy':
            return {'loss_ent': prob2ent(prob).sum(dim=1).mean()
                    * self.weights.get('loss_ent', 1.0)}
        return {'loss_max_square': -(prob**2).mean() / 2
                * self.weights.get('loss_max_square', 1.0)}
