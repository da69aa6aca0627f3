"""Adversarial domain-adaptation loss (port of
``pfst_tpu/models/losses/adv_loss.py``; mirrors
``rsiseg/models/losses/adv_loss.py:13-112``), on NCHW tensors.

``__call__(discriminator, tensors)`` takes a callable that runs the
discriminator, so the loss holds no parameters: the adversarial adaptor
passes its discriminator, updated or frozen as the phase needs.
"""
from __future__ import annotations

import torch

from ..builder import LOSSES
from .entropy_loss import prob2ent


def _l1_to_label(pred: torch.Tensor, label: float) -> torch.Tensor:
    """The mean absolute distance to a constant label (the reference's
    ``F.l1_loss`` against a filled tensor)."""
    return (pred - label).abs().mean()


def _entropy_map(logits: torch.Tensor) -> torch.Tensor:
    return prob2ent(torch.softmax(logits.float(), dim=1))


@LOSSES.register_module()
class AdvLoss:
    """``advent``: ``disc`` scores the entropy maps of the detached source
    and target predictions against the labels 0 and 1; ``gen`` scores the
    target's, with its gradient, against the source label 0. Both are L1
    to the label, as the reference computes them, not BCE
    (``adv_loss.py:37-67``)."""

    def __init__(self, loss_type='advent', net_type='gen', weights=None,
                 **kwargs):
        if loss_type != 'advent':
            raise ValueError(loss_type)
        if net_type not in ('gen', 'disc'):
            raise ValueError(net_type)
        self.loss_type = loss_type
        self.net_type = net_type
        self._loss_name = f'adv_loss_{loss_type}_{net_type}'
        self.weights = weights or {}

    @property
    def loss_name(self):
        return self._loss_name

    def __call__(self, discriminator, tensors):
        src_label, trg_label = 0.0, 1.0
        w = self.weights
        if self.net_type == 'disc':
            d_src = discriminator(_entropy_map(
                tensors['logits_src'].detach()))
            d_trg = discriminator(_entropy_map(
                tensors['logits_trg'].detach()))
            return {'loss_disc_src': _l1_to_label(d_src, src_label)
                    * w.get('loss_disc_src', 1.0),
                    'loss_disc_trg': _l1_to_label(d_trg, trg_label)
                    * w.get('loss_disc_trg', 1.0)}
        d_trg = discriminator(_entropy_map(tensors['logits_trg']))
        return {'loss_gen': _l1_to_label(d_trg, src_label)
                * w.get('loss_gen', 1.0)}
