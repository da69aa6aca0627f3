"""FeatSim loss family (port of
``pfst_tpu/models/losses/feat_sim_loss.py``), on NCHW tensors.

* ``FeatSimLoss``: per feature level of a list, the ``top_k + 1`` most
  similar neighbors pulled by the student's class agreement and the
  ``top_k`` least similar pushed by its disagreement;
* ``FeatSimLossV2``: the same on given similarity maps;
* ``AdaptiveFeatSimLoss`` (the UDA ``tensors`` dict): the source gt-pair
  contrast on the student's source features, and the top-k pull / push
  of the teacher features' similarity weighted by the student's target
  agreement, masked by the source labels' validity with
  ``apply_ignore``; ``V2`` (and ``V3``, ``V4``, as in the JAX file) also
  by the inverse ClassMix mask; ``MultiScaleAdaptiveFeatSimLoss`` per
  level with ``_{level}`` suffixes.

The similarities go through ``ops.neighborhood_similarity``: on the card
the forward kernel, and its backward for the source similarity, which
carries the gradient to the student's features; on the CPU the plain
version, the JAX file's formula. ``torch.topk`` may order equal
similarities otherwise than ``jax.lax.top_k`` (ROADMAP C2).
"""
from __future__ import annotations

import torch

from ...ops import neighborhood_similarity, resize, unfold_neighbors
from ..builder import LOSSES
from .utils import masked_mean


def _sim(feats, k, d, sim_type, sigma):
    """(B, k*k, H, W) neighborhood similarity of an NCHW feature map."""
    if sim_type not in ('gaussian', 'cosine'):
        raise ValueError(f'unknown sim_type {sim_type}')
    return neighborhood_similarity(feats, k, d, sim_type=sim_type,
                                   sigma=float(sigma))


def _nearest(x, size):
    return resize(x, size=size, mode='nearest')


def _cross_prob(seg_logits, k, d):
    """``p`` softmax over the classes, its unfolded neighbors and their
    agreement ``sum_c p q`` (B, k*k, H, W)."""
    p = torch.softmax(seg_logits, dim=1)
    unf_p = unfold_neighbors(p, k, d)                     # (B, k2, C, H, W)
    return p, unf_p, (p[:, None] * unf_p).sum(dim=2)


def _topk_pull_push(sim_feat, cross_pos, cross_neg, top_k):
    """The pull of the ``top_k + 1`` most similar neighbors by the
    agreement and the push of the ``top_k`` least similar by the
    disagreement (``feat_sim_loss.py:53-70``); ``top_k=None`` takes every
    neighbor."""
    if top_k is None:
        return sim_feat * -cross_pos, (1.0 - sim_feat) * -cross_neg
    top_sim, top_idx = sim_feat.topk(top_k + 1, dim=1)
    min_sim, min_idx = sim_feat.topk(top_k, dim=1, largest=False)
    return (top_sim * -cross_pos.gather(1, top_idx),
            (1.0 - min_sim) * -cross_neg.gather(1, min_idx))


def _level_terms(losses, idx, sim_feat, mask, cross_pos, cross_neg,
                 top_k, weights):
    loc_pos, loc_neg = _topk_pull_push(sim_feat, cross_pos, cross_neg,
                                       top_k)
    losses[f'loss_sim_pos_{idx}'] = masked_mean(
        loc_pos, mask.expand_as(loc_pos)) * weights[idx][0]
    losses[f'loss_sim_neg_{idx}'] = masked_mean(
        loc_neg, mask.expand_as(loc_neg)) * weights[idx][1]


@LOSSES.register_module()
class FeatSimLoss:
    """Multi-level pull / push against logits (``feat_sim_loss.py:73``)."""

    def __init__(self, top_k, dilation, kernel_size, sigmas, weights,
                 sim_type='gaussian'):
        self.top_k = top_k
        self.dilation = dilation
        self.kernel_size = kernel_size
        self.sigmas = sigmas
        self.weights = weights
        self.sim_type = sim_type

    def __call__(self, ori_feats_list, seg_logits):
        """``ori_feats_list``: (B, C_i, h_i, w_i) maps; ``seg_logits`` (B,
        C, H, W). Returns (losses, states)."""
        k, d = self.kernel_size, self.dilation
        size = tuple(seg_logits.shape[2:])
        p, unf_p, cross_pos = _cross_prob(seg_logits, k, d)
        # the mass of every class pair minus the diagonal
        cross_neg = p.sum(dim=1, keepdim=True) * unf_p.sum(dim=2) - cross_pos
        losses = {}
        sim_feat = None
        for idx, ori in enumerate(ori_feats_list):
            feats = _nearest(ori, size)
            sigma = self.sigmas[idx] if self.sim_type == 'gaussian' else 1.0
            sim_feat = _sim(feats, k, d, self.sim_type, sigma)
            _level_terms(losses, idx, sim_feat, (feats[:, :1] > 0),
                         cross_pos, cross_neg, self.top_k, self.weights)
        states = dict(sim_feat=sim_feat.detach().mean(dim=1))
        return losses, states


@LOSSES.register_module()
class FeatSimLossV2:
    """Given similarity maps (B, k*k, h_i, w_i), each nearest-resized to
    the logits' size (``feat_sim_loss.py:120``)."""

    def __init__(self, top_k, dilation, kernel_size, sigmas=None,
                 weights=None):
        self.top_k = top_k
        self.dilation = dilation
        self.kernel_size = kernel_size
        self.sigmas = sigmas
        self.weights = weights

    def __call__(self, ori_sim_feats_list, seg_logits):
        k, d = self.kernel_size, self.dilation
        size = tuple(seg_logits.shape[2:])
        p, unf_p, cross_pos = _cross_prob(seg_logits, k, d)
        cross_neg = p.sum(dim=1, keepdim=True) * unf_p.sum(dim=2) - cross_pos
        losses = {}
        for idx, ori_sim in enumerate(ori_sim_feats_list):
            sim_feat = _nearest(ori_sim, size)
            _level_terms(losses, idx, sim_feat, (sim_feat[:, :1] > 0),
                         cross_pos, cross_neg, self.top_k, self.weights)
        states = dict(sim_feat=ori_sim_feats_list[0].detach().mean(dim=1))
        return losses, states


@LOSSES.register_module()
class AdaptiveFeatSimLoss:
    """The UDA ``tensors`` variant (``feat_sim_loss.py:167``)."""

    # V2 restricts the target terms to true-target pixels as well
    use_trg_mask = False

    def __init__(self, top_k, dilation, kernel_size, weights, sigma=30,
                 mean_sim=0.6, feat_level=2, sim_type='gaussian',
                 num_bins=100, apply_ignore=False):
        del mean_sim, num_bins    # accepted for config compatibility
        self.top_k = top_k
        self.dilation = dilation
        self.kernel_size = kernel_size
        self.weights = weights
        self.sigma = sigma
        self.feat_level = feat_level
        self.sim_type = sim_type
        self.apply_ignore = apply_ignore

    def _level_losses(self, tensors, x_ema, x_src, suffix=''):
        logits_trg = tensors['logits_trg']
        img_trg = tensors.get('img_trg')
        k, d = self.kernel_size, self.dilation
        b, _, h, w = logits_trg.shape
        size = (h, w)

        gt = _nearest(tensors['gt_src'][:, None].float(), size)  # (B,1,H,W)
        ignore_src = gt[:, 0] != 255 if self.apply_ignore else torch.ones(
            (b, h, w), dtype=torch.bool, device=logits_trg.device)

        # the student's target agreement (``feat_sim_loss.py:206-212``)
        _, _, cross_pos = _cross_prob(logits_trg, k, d)
        cross_neg = 1.0 - cross_pos

        ema_sim = _sim(_nearest(x_ema, size), k, d, self.sim_type,
                       self.sigma)
        src_sim = _sim(_nearest(x_src, size), k, d, self.sim_type,
                       self.sigma)

        # source gt-pair contrast (``feat_sim_loss.py:219-225``)
        unf_gt = unfold_neighbors(gt, k, d)[:, :, 0]     # (B, k2, H, W)
        src_valid = ignore_src[:, None]
        src_pos_mean = masked_mean(src_sim, (unf_gt == gt) & src_valid)
        src_neg_mean = masked_mean(src_sim, (unf_gt != gt) & src_valid)

        # target pull / push (``feat_sim_loss.py:227-241``)
        valid = ignore_src
        if self.use_trg_mask:
            inv_mix = 1.0 - _nearest(tensors['mix_masks'][:, None].float(),
                                     size)
            valid = valid & (inv_mix[:, 0] > 0.5)
        loc_pos, loc_neg = _topk_pull_push(ema_sim, cross_pos, cross_neg,
                                           self.top_k)
        vc = valid[:, None]
        losses = {
            f'loss_src_pos{suffix}':
                -src_pos_mean * self.weights['src_pos'],
            f'loss_src_neg{suffix}':
                src_neg_mean * self.weights['src_neg'],
            f'loss_sim_pos{suffix}': masked_mean(
                loc_pos, vc.expand_as(loc_pos)) * self.weights['sim_pos'],
            f'loss_sim_neg{suffix}': masked_mean(
                loc_neg, vc.expand_as(loc_neg)) * self.weights['sim_neg'],
        }
        if img_trg is not None:
            vis = (img_trg, 1.0 - ema_sim.detach().mean(dim=1, keepdim=True))
            if self.use_trg_mask:
                vis = vis + (vc,)
            losses[f'vis|density_sim_feat{suffix}'] = vis
        return losses

    def __call__(self, tensors):
        x_ema = tensors['x_ema']
        x_src = tensors['x_src']
        if self.feat_level is not None:
            x_ema = x_ema[self.feat_level]
            x_src = x_src[self.feat_level]
        return self._level_losses(tensors, x_ema, x_src)


@LOSSES.register_module()
class AdaptiveFeatSimLossV2(AdaptiveFeatSimLoss):
    """V1 with the target terms on true-target pixels only."""

    use_trg_mask = True


@LOSSES.register_module()
class AdaptiveFeatSimLossV3(AdaptiveFeatSimLossV2):
    """V2's semantics, as in the JAX file (the reference's V3 does not
    run)."""


@LOSSES.register_module()
class AdaptiveFeatSimLossV4(AdaptiveFeatSimLossV2):
    """V2's semantics, as in the JAX file (the reference's V4 cannot be
    built; its forward is V2's)."""


@LOSSES.register_module()
class MultiScaleAdaptiveFeatSimLoss(AdaptiveFeatSimLoss):
    """V1 per feature level, the keys suffixed ``_{level}``."""

    def __init__(self, top_k, dilation, kernel_size, weights, sigma=30,
                 mean_sim=0.6, feat_level=(2,), sim_type='gaussian',
                 num_bins=100, apply_ignore=False):
        super().__init__(top_k, dilation, kernel_size, weights, sigma=sigma,
                         mean_sim=mean_sim, feat_level=None,
                         sim_type=sim_type, num_bins=num_bins,
                         apply_ignore=apply_ignore)
        self.feat_levels = tuple(feat_level)

    def __call__(self, tensors):
        losses = {}
        for lvl in self.feat_levels:
            losses.update(self._level_losses(
                tensors, tensors['x_ema'][lvl], tensors['x_src'][lvl],
                suffix=f'_{lvl}'))
        return losses
