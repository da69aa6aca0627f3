"""Cross-entropy losses with mmseg's semantics (port of
``pfst_tpu/models/losses/cross_entropy_loss.py``).

Ignored pixels are zeroed, not dropped; the mean runs over all pixels,
ignored ones included, unless ``avg_non_ignore``; pixel weights multiply
before the mean. Logits are NCHW ``(B, C, H, W)``, labels ``(B, H, W)``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ..builder import LOSSES
from .utils import get_class_weight, weight_reduce_loss


def cross_entropy(pred: torch.Tensor,
                  label: torch.Tensor,
                  weight: Optional[torch.Tensor] = None,
                  class_weight=None,
                  reduction: str = 'mean',
                  avg_factor=None,
                  ignore_index: int = -100,
                  avg_non_ignore: bool = False) -> torch.Tensor:
    """Softmax CE (``cross_entropy_loss.py:22-46``)."""
    num_classes = pred.shape[1]
    valid = (label != ignore_index) & (label >= 0) & (label < num_classes)
    safe_label = torch.where(valid, label, 0).long()
    logp = F.log_softmax(pred.float(), dim=1)
    nll = -logp.gather(1, safe_label[:, None])[:, 0]
    if class_weight is not None:
        cw = torch.as_tensor(class_weight, dtype=torch.float32,
                             device=pred.device)
        nll = nll * cw[safe_label]
    loss = torch.where(valid, nll, 0.0)
    if avg_factor is None and avg_non_ignore and reduction == 'mean':
        avg_factor = valid.float().sum()
    if weight is not None:
        weight = weight.float()
    return weight_reduce_loss(loss, weight=weight, reduction=reduction,
                              avg_factor=avg_factor)


def _bce_with_logits(pred, target):
    return pred.clamp(min=0) - pred * target + \
        torch.log1p(torch.exp(-pred.abs()))


def binary_cross_entropy(pred: torch.Tensor,
                         label: torch.Tensor,
                         weight: Optional[torch.Tensor] = None,
                         reduction: str = 'mean',
                         avg_factor=None,
                         class_weight=None,
                         ignore_index: int = -100,
                         avg_non_ignore: bool = False,
                         **kwargs) -> torch.Tensor:
    """Sigmoid BCE (``cross_entropy_loss.py:49-104``). ``pred`` has one
    channel (binary target), or the label is a float multi-hot target of
    the same shape, or the label is expanded one-hot over C channels."""
    del kwargs
    pred = pred.float()
    if pred.shape[1] == 1:
        pred = pred[:, 0]
        valid = label != ignore_index
        target = torch.where(valid, label, 0).float()
        loss = torch.where(valid, _bce_with_logits(pred, target), 0.0)
        if avg_factor is None and avg_non_ignore and reduction == 'mean':
            avg_factor = valid.float().sum()
        if weight is not None:
            weight = weight.float()
        return weight_reduce_loss(loss, weight, reduction, avg_factor)
    cw = None if class_weight is None else torch.as_tensor(
        class_weight, dtype=torch.float32, device=pred.device).view(
            1, -1, *([1] * (pred.ndim - 2)))
    if label.shape == pred.shape and label.is_floating_point():
        loss = _bce_with_logits(pred, label.float())
        if cw is not None:
            loss = loss * cw
        if weight is not None:
            weight = weight.float()
        return weight_reduce_loss(loss, weight, reduction, avg_factor)
    num_classes = pred.shape[1]
    valid = (label >= 0) & (label != ignore_index)
    safe = torch.where(valid, label, 0).long()
    vmask = valid[:, None].float()
    onehot = F.one_hot(safe, num_classes).movedim(-1, 1).float() * vmask
    loss = _bce_with_logits(pred, onehot)
    if cw is not None:
        loss = loss * cw
    loss = loss * vmask
    if weight is not None:
        weight = weight[:, None].float()
    if avg_factor is None and avg_non_ignore and reduction == 'mean':
        avg_factor = valid.float().sum() * num_classes
    return weight_reduce_loss(loss, weight, reduction, avg_factor)


@LOSSES.register_module()
class CrossEntropyLoss:
    """Config-facing CE loss (``cross_entropy_loss.py:107-143``)."""

    def __init__(self,
                 use_sigmoid: bool = False,
                 use_mask: bool = False,
                 reduction: str = 'mean',
                 class_weight: Optional[Sequence[float]] = None,
                 loss_weight: float = 1.0,
                 loss_name: str = 'loss_ce',
                 avg_non_ignore: bool = False):
        if use_mask:
            raise NotImplementedError('mask CE is for instance segmentation')
        self.use_sigmoid = use_sigmoid
        self.reduction = reduction
        self.class_weight = get_class_weight(class_weight)
        self.loss_weight = loss_weight
        self.avg_non_ignore = avg_non_ignore
        self.loss_name = loss_name
        self.criterion = binary_cross_entropy if use_sigmoid \
            else cross_entropy

    def __call__(self, pred, label, weight=None, avg_factor=None,
                 reduction_override=None, ignore_index=-100, **kwargs):
        del kwargs
        loss = self.criterion(
            pred, label, weight,
            class_weight=self.class_weight,
            reduction=reduction_override or self.reduction,
            avg_factor=avg_factor,
            ignore_index=ignore_index,
            avg_non_ignore=self.avg_non_ignore)
        return self.loss_weight * loss
