"""PFST loss family (port of ``pfst_tpu/models/losses/pfst_loss.py``), on
NCHW tensors.

* ``PFSTLoss``: soft pseudo-labels from a similarity-weighted vote over
  the teacher logits of the ``top_k + 1`` most and the ``top_k`` least
  similar neighbors, and a per-class BCE of the student's target logits
  against them (pulled to the similar vote, pushed from the dissimilar
  one), on target pixels only;
* ``PFSTLossV2``: the cross-class agreement of the student's target
  prediction, pulled where the teacher features are dissimilar
  (``sim < tau_pos``) between equal predictions and pushed where they
  are similar (``sim > tau_neg``) between different ones, on the eroded
  target mask, plus the source same / different-label contrast on the
  student's features;
* ``PFSTLossV4``: the JAX file's alias of V2.

The similarities go through ``ops.neighborhood_similarity``: on the card
the forward kernel (and its backward where the student's features get a
gradient, V2's ``src_sim``), on the CPU the plain version, which is the
JAX file's formula. ``torch.topk`` may order equal similarities otherwise
than ``jax.lax.top_k`` (ROADMAP C2). The ``vis|`` entries come with an
``img_trg``; they are never part of the total.
"""
from __future__ import annotations

import torch

from ...ops import neighborhood_similarity, resize, unfold_neighbors
from ..builder import LOSSES
from .utils import masked_mean


def _nearest(x, size):
    return resize(x, size=size, mode='nearest')


def _sim_feat(x, size, kernel_size, dilation, sim_type, sigma):
    """(feats, sim): ``x`` nearest-resized to ``size`` and its (B, k*k, H,
    W) neighborhood similarity (``pfst_loss.py:31-45``)."""
    if sim_type not in ('gaussian', 'cosine'):
        raise ValueError(f'unknown sim_type {sim_type}')
    feats = _nearest(x, size)
    return feats, neighborhood_similarity(feats, kernel_size, dilation,
                                          sim_type=sim_type,
                                          sigma=float(sigma))


def _bce_none(logits, target):
    return torch.clamp(logits, min=0) - logits * target + \
        torch.log1p(torch.exp(-logits.abs()))


def _density(sim):
    return 1.0 - sim.detach().mean(dim=1, keepdim=True)


@LOSSES.register_module()
class PFSTLoss:

    def __init__(self, top_k, dilation, kernel_size, weights, sigma=30,
                 mean_sim=0.6, feat_level=2, sim_type='cosine'):
        del mean_sim    # accepted for config compatibility, as in JAX
        self.top_k = top_k
        self.dilation = dilation
        self.kernel_size = kernel_size
        self.weights = weights
        self.sigma = sigma
        self.feat_level = feat_level
        self.sim_type = sim_type

    def __call__(self, tensors):
        logits_trg = tensors['logits_trg']               # (B, C, H, W)
        x_ema = tensors['x_ema']
        if self.feat_level is not None:
            x_ema = x_ema[self.feat_level]
        img_trg = tensors.get('img_trg')
        size = tuple(logits_trg.shape[2:])
        k, d = self.kernel_size, self.dilation

        inv_mix = 1.0 - _nearest(tensors['mix_masks'][:, None].float(),
                                 size)
        ignore_trg = inv_mix > 0.5                       # (B, 1, H, W)

        logits_ema = resize(tensors['logits_ema'], size=size,
                            mode='bilinear', align_corners=False)
        unf_logits_ema = unfold_neighbors(logits_ema, k, d)  # (B,k2,C,H,W)
        _, ema_sim = _sim_feat(x_ema, size, k, d, self.sim_type,
                               self.sigma)

        # similarity-weighted neighbor-logit vote (``pfst_loss.py:86-100``)
        top_sim, top_idx = ema_sim.topk(self.top_k + 1, dim=1)
        min_sim, min_idx = ema_sim.topk(self.top_k, dim=1, largest=False)

        def vote(sim, idx):
            c = unf_logits_ema.shape[2]
            picked = unf_logits_ema.gather(
                1, idx[:, :, None].expand(-1, -1, c, -1, -1))
            return (sim[:, :, None] * picked).sum(dim=1)

        pl_pos = torch.softmax(vote(top_sim, top_idx), dim=1)
        pl_neg = torch.softmax(vote(min_sim, min_idx), dim=1)

        mask = ignore_trg.expand_as(logits_trg)
        losses = {
            'loss_sim_pos': masked_mean(_bce_none(logits_trg, pl_pos),
                                        mask) * self.weights['sim_pos'],
            'loss_sim_neg': masked_mean(-_bce_none(logits_trg, pl_neg),
                                        mask) * self.weights['sim_neg'],
        }
        if img_trg is not None:
            losses['vis|density_sim_feat'] = (img_trg, _density(ema_sim))
            losses['vis|seg_mask_sim_pseudo_labels'] = (
                img_trg, pl_pos.argmax(dim=1, keepdim=True),
                pl_neg.argmax(dim=1, keepdim=True))
        return losses


@LOSSES.register_module()
class PFSTLossV2:

    def __init__(self, top_k, dilation, kernel_size, weights, sigma=30,
                 mean_sim=0.6, feat_level=2, sim_type='gaussian',
                 tau_pos=0.25, tau_neg=0.75, border_margin=None):
        del mean_sim
        self.top_k = top_k
        self.dilation = dilation
        self.kernel_size = kernel_size
        self.weights = weights
        self.sigma = sigma
        self.feat_level = feat_level
        self.sim_type = sim_type
        self.tau_pos = tau_pos
        self.tau_neg = tau_neg
        self.border_margin = border_margin

    def __call__(self, tensors):
        k, d = self.kernel_size, self.dilation
        k2 = k * k
        logits_trg = tensors['logits_trg']
        x_ema = tensors['x_ema']
        x_src = tensors['x_src']
        if self.feat_level is not None:
            x_ema = x_ema[self.feat_level]
            x_src = x_src[self.feat_level]
        img_trg = tensors.get('img_trg')
        h, w = size = tuple(logits_trg.shape[2:])

        gt = _nearest(tensors['gt_src'][:, None].float(), size)  # (B,1,H,W)
        ignore_src = gt[:, 0] != 255                             # (B, H, W)
        inv_mix = (1.0 - _nearest(tensors['mix_masks'][:, None].float(),
                                  size))[:, 0] > 0.5

        # cross-class agreement (PFGST's ``sum_c p q``)
        p = torch.softmax(logits_trg, dim=1)
        unf_p = unfold_neighbors(p, k, d)                # (B, k2, C, H, W)
        cross_prob_pos = (p[:, None] * unf_p).sum(dim=2)  # (B, k2, H, W)

        _, ema_sim = _sim_feat(x_ema, size, k, d, self.sim_type, self.sigma)
        _, src_sim = _sim_feat(x_src, size, k, d, self.sim_type, self.sigma)

        unf_gt = unfold_neighbors(gt, k, d)[:, :, 0]     # (B, k2, H, W)
        src_valid = ignore_src[:, None]
        losses = {
            'loss_src_pos': -masked_mean(
                src_sim, (unf_gt == gt) & src_valid) *
            self.weights['src_pos'],
            'loss_src_neg': masked_mean(
                src_sim, (unf_gt != gt) & src_valid) *
            self.weights['src_neg'],
        }

        # prediction-agreement pairs over the student's argmax
        pred = logits_trg.argmax(dim=1, keepdim=True).float()
        unf_pred = unfold_neighbors(pred, k, d)[:, :, 0]
        pos_sim_mask = (ema_sim < self.tau_pos) & (unf_pred == pred)
        neg_sim_mask = (ema_sim > self.tau_neg) & (unf_pred != pred)

        center_valid = (ignore_src & inv_mix)[:, None].float()
        eroded = unfold_neighbors(center_valid, k, d)[:, :, 0].sum(
            dim=1) == k2                                 # (B, H, W)
        if self.border_margin is not None:
            # the JAX file's (and the reference's) corner squares only:
            # top-left and bottom-right (``pfst_loss.py:196-206``)
            m = self.border_margin
            rows = torch.arange(h, device=eroded.device)[None, :, None]
            cols = torch.arange(w, device=eroded.device)[None, None, :]
            border = ((rows < m) & (cols < m)) | \
                ((rows >= h - m) & (cols >= w - m))
            eroded = eroded & ~border
        pos_sim_mask = pos_sim_mask & eroded[:, None]
        neg_sim_mask = neg_sim_mask & eroded[:, None]

        losses['loss_sim_pos'] = masked_mean(
            cross_prob_pos, pos_sim_mask) * self.weights['sim_pos']
        losses['loss_sim_neg'] = -masked_mean(
            cross_prob_pos, neg_sim_mask) * self.weights['sim_neg']
        if img_trg is not None:
            losses['vis|density_sim_feat'] = (img_trg, _density(ema_sim))
        return losses


@LOSSES.register_module()
class PFSTLossV4(PFSTLossV2):
    """The JAX file's (and the reference's) V4 is V2."""
