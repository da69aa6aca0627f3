"""Lovasz-Softmax loss (port of ``pfst_tpu/models/losses/lovasz_loss.py``).

Per class, the pixels' errors ``|fg - p_c|`` (0 at ignored pixels) sorted
in descending order, ties in pixel order (a stable sort, as the JAX
file's ``argsort`` of the negated errors), dotted with the Lovasz
extension's gradient of the sorted foreground; a class absent from the
labels adds 0. ``classes='present'`` averages over the present classes,
anything else over all; ``per_image`` averages the images' losses, else
the batch is one set of pixels. All classes are done at once. Logits are
NCHW.
"""
from __future__ import annotations

import torch

from ..builder import LOSSES
from .utils import get_class_weight


def lovasz_grad(gt_sorted):
    """The Lovasz extension's gradient at sorted errors, along the last
    dimension of ``gt_sorted``."""
    gts = gt_sorted.sum(-1, keepdim=True)
    intersection = gts - gt_sorted.cumsum(-1)
    union = gts + (1.0 - gt_sorted).cumsum(-1)
    jaccard = 1.0 - intersection / union
    return torch.cat([jaccard[..., :1], jaccard[..., 1:] - jaccard[..., :-1]],
                     dim=-1)


def _lovasz_flat(probs, labels, classes, class_weight, ignore_index):
    """``probs`` (C, P), ``labels`` (P,) -> the loss over these pixels."""
    num_classes = probs.shape[0]
    valid = (labels != ignore_index).float()
    fg = (labels[None] == torch.arange(num_classes, device=labels.device)
          [:, None]).float() * valid
    errors = (fg - probs).abs() * valid
    errors_sorted, order = errors.sort(dim=1, descending=True, stable=True)
    loss = (errors_sorted * lovasz_grad(fg.gather(1, order))).sum(1)
    present = fg.sum(1) > 0
    loss = torch.where(present, loss, 0.0)
    if class_weight is not None:
        loss = loss * torch.as_tensor(class_weight, dtype=loss.dtype,
                                      device=loss.device)
    count = present.float().sum() if classes == 'present' \
        else float(num_classes)
    return loss.sum() / torch.clamp(torch.as_tensor(count), min=1.0)


def lovasz_softmax(probs, labels, classes='present', per_image=False,
                   class_weight=None, ignore_index=255):
    """``probs`` (B, C, H, W), ``labels`` (B, H, W)."""
    c = probs.shape[1]
    if per_image:
        return torch.stack([
            _lovasz_flat(p.reshape(c, -1), l.reshape(-1), classes,
                         class_weight, ignore_index)
            for p, l in zip(probs, labels)]).mean()
    return _lovasz_flat(probs.transpose(0, 1).reshape(c, -1),
                        labels.reshape(-1), classes, class_weight,
                        ignore_index)


@LOSSES.register_module()
class LovaszLoss:

    def __init__(self, loss_type='multi_class', classes='present',
                 per_image=False, reduction='mean', class_weight=None,
                 loss_weight=1.0, loss_name='loss_lovasz'):
        assert loss_type == 'multi_class', \
            'binary lovasz: use multi_class with 2 classes'
        self.classes = classes
        self.per_image = per_image
        self.reduction = reduction
        self.class_weight = get_class_weight(class_weight)
        self.loss_weight = loss_weight
        self.loss_name = loss_name

    def __call__(self, pred, target, weight=None, avg_factor=None,
                 reduction_override=None, ignore_index=255, **kwargs):
        del weight, avg_factor, reduction_override, kwargs
        probs = torch.softmax(pred.float(), dim=1)
        return self.loss_weight * lovasz_softmax(
            probs, target, self.classes, self.per_image, self.class_weight,
            ignore_index)
