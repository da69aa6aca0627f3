"""Dice loss (port of ``pfst_tpu/models/losses/dice_loss.py``).

As in the JAX file: labels clamped into [0, C - 1], so an ignored 255 is
one-hot in class C - 1, and while the numerator masks ignored pixels the
denominator does not (mmseg's ``dice_loss.py:108-110``); the per-class
losses are summed and divided by all C classes. Logits are NCHW.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..builder import LOSSES
from .utils import get_class_weight, weight_reduce_loss


def dice_loss(pred, target, valid_mask, smooth=1, exponent=2,
              class_weight=None):
    """``pred`` probabilities and ``target`` one-hot (B, C, H, W), ``valid``
    (B, H, W) -> (B,): the mean over the C classes of each binary Dice
    loss."""
    b, c = pred.shape[:2]
    pred, target = pred.reshape(b, c, -1), target.reshape(b, c, -1)
    valid = valid_mask.reshape(b, 1, -1)
    num = (pred * target * valid).sum(2) * 2 + smooth
    den = (pred**exponent + target**exponent).sum(2) + smooth
    loss = 1 - num / den                                 # (B, C)
    if class_weight is not None:
        loss = loss * torch.as_tensor(class_weight, dtype=loss.dtype,
                                      device=loss.device)
    return loss.sum(1) / c


@LOSSES.register_module()
class DiceLoss:

    def __init__(self, smooth=1, exponent=2, reduction='mean',
                 class_weight=None, loss_weight=1.0, ignore_index=255,
                 loss_name='loss_dice', **kwargs):
        del kwargs
        self.smooth = smooth
        self.exponent = exponent
        self.reduction = reduction
        self.class_weight = get_class_weight(class_weight)
        self.loss_weight = loss_weight
        self.ignore_index = ignore_index
        self.loss_name = loss_name

    def __call__(self, pred, target, weight=None, avg_factor=None,
                 reduction_override=None, ignore_index=None, **kwargs):
        del weight, kwargs
        reduction = reduction_override or self.reduction
        ignore = self.ignore_index if ignore_index is None else ignore_index
        num_classes = pred.shape[1]
        probs = torch.softmax(pred.float(), dim=1)
        valid = (target != ignore).float()
        safe = target.clamp(0, num_classes - 1).long()
        one_hot = F.one_hot(safe, num_classes).movedim(-1, 1).float()
        loss = dice_loss(probs, one_hot, valid, self.smooth, self.exponent,
                         self.class_weight)
        return self.loss_weight * weight_reduce_loss(loss, None, reduction,
                                                     avg_factor)
