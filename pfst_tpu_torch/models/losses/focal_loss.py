"""Sigmoid focal loss (port of ``pfst_tpu/models/losses/focal_loss.py``).

Each class's sigmoid BCE against the one-hot label, times ``alpha`` (1 -
``alpha`` off the class) and ``pt ** gamma``; ignored pixels are zero,
and the mean runs over every pixel and class. Logits are NCHW.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..builder import LOSSES
from .utils import weight_reduce_loss


def sigmoid_focal_loss(pred, target_onehot, gamma=2.0, alpha=0.5,
                       class_weight=None):
    """The elementwise focal term of (B, C, H, W) logits."""
    pred = pred.float()
    p = torch.sigmoid(pred)
    pt = (1 - p) * target_onehot + p * (1 - target_onehot)
    focal_weight = (alpha * target_onehot +
                    (1 - alpha) * (1 - target_onehot)) * pt**gamma
    bce = pred.clamp(min=0) - pred * target_onehot + \
        torch.log1p(torch.exp(-pred.abs()))
    loss = bce * focal_weight
    if class_weight is not None:
        loss = loss * torch.as_tensor(class_weight, dtype=torch.float32,
                                      device=pred.device).view(1, -1, 1, 1)
    return loss


@LOSSES.register_module()
class FocalLoss:

    def __init__(self, use_sigmoid=True, gamma=2.0, alpha=0.5,
                 reduction='mean', class_weight=None, loss_weight=1.0,
                 loss_name='loss_focal'):
        assert use_sigmoid, 'only sigmoid focal loss is supported'
        self.gamma = gamma
        self.alpha = alpha
        self.reduction = reduction
        self.class_weight = class_weight
        self.loss_weight = loss_weight
        self.loss_name = loss_name

    def __call__(self, pred, target, weight=None, avg_factor=None,
                 reduction_override=None, ignore_index=255, **kwargs):
        del kwargs
        reduction = reduction_override or self.reduction
        num_classes = pred.shape[1]
        valid = (target != ignore_index)[:, None].float()
        safe = torch.where(target != ignore_index, target, 0).long()
        onehot = F.one_hot(safe, num_classes).movedim(-1, 1).float() * valid
        loss = sigmoid_focal_loss(pred, onehot, self.gamma, self.alpha,
                                  self.class_weight) * valid
        if weight is not None:
            loss = loss * weight[:, None].float()
        return self.loss_weight * weight_reduce_loss(loss, None, reduction,
                                                     avg_factor)
