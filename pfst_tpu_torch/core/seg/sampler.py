"""Pixel samplers (port of ``pfst_tpu/core/seg/sampler.py``).

``OHEMPixelSampler`` mines the hard pixels of a CE loss, per image, as the
JAX file does:

* with ``thresh``: the pixels whose gt-class probability lies below
  ``max(thresh, p_k)``, ``p_k`` the k-th smallest probability of the
  image's valid pixels, k = ``min_kept`` clamped into them (``:57-73``;
  no valid pixel gives ``p_k`` 0);
* without: the pixels whose CE is at least the ``min_kept``-th largest
  over all of the image's pixels, ignored ones at -inf (``:76-88``).

Ignored pixels get weight 0. Logits are NCHW, labels (B, H, W); the
weight is fp32 (B, H, W) and carries no gradient.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ...utils.registry import Registry

PIXEL_SAMPLERS = Registry('pixel sampler')


def build_pixel_sampler(cfg, **default_args):
    return PIXEL_SAMPLERS.build(dict(cfg), **default_args)


class BasePixelSampler:

    def sample(self, seg_logit, seg_label):
        raise NotImplementedError


@PIXEL_SAMPLERS.register_module()
class OHEMPixelSampler(BasePixelSampler):

    def __init__(self, context=None, thresh: Optional[float] = None,
                 min_kept: int = 100000, ignore_index: int = 255):
        assert min_kept > 1
        self.context = context
        self.thresh = thresh
        self.min_kept = min_kept
        self.ignore_index = ignore_index

    @torch.no_grad()
    def sample(self, seg_logit, seg_label):
        """``seg_logit`` (B, C, H, W), ``seg_label`` (B, H, W) -> weight
        (B, H, W)."""
        b = seg_logit.shape[0]
        n_px = seg_label[0].numel()
        kept = min(self.min_kept, n_px)
        valid = seg_label != self.ignore_index
        safe = torch.where(valid, seg_label, 0).long()[:, None]
        if self.thresh is not None:
            probs = torch.softmax(seg_logit.float(), dim=1)
            gt_prob = torch.where(valid, probs.gather(1, safe)[:, 0], 1.0)
            flat = torch.where(valid, gt_prob, torch.inf).reshape(b, -1)
            nv = valid.reshape(b, -1).sum(1)
            k = torch.clamp(torch.clamp(nv - 1, max=kept), 0, n_px - 1)
            kth = flat.sort(dim=1).values.gather(1, k[:, None])[:, 0]
            threshold = torch.clamp(torch.where(nv > 0, kth, 0.0),
                                    min=self.thresh)
            sel = gt_prob < threshold[:, None, None]
        else:
            nll = -F.log_softmax(seg_logit.float(), dim=1).gather(1, safe)
            losses = torch.where(valid, nll[:, 0], -torch.inf)
            kth = losses.reshape(b, -1).sort(dim=1).values[:, n_px - kept]
            sel = losses >= kth[:, None, None]
        return (sel & valid).float()
