"""PFGST neighborhood-similarity loss (port of
``pfst_tpu/models/losses/pfgst_loss.py``), on NCHW tensors.

The semantics are the JAX file's:

* ``downscale``: nearest resize of ``logits_trg`` by the factor; the
  features are nearest-resized to the logits' size;
* target mask: a pixel counts only if all k*k neighbors come from the
  target image (erosion of the mix-mask complement; zero padding drops
  the border);
* source contrast on same/different-label neighbor pairs, with mean/std
  or margin losses; padded neighbors read as class 0;
* cross-class-probability agreement ``sum_c p q``, the top-k most / least
  similar neighbors pulled / pushed (``top_k + 1`` for the pull, which
  holds the center);
* the similarity losses are 0 unless more than one pixel is valid.

``get_sim_feat`` calls ``ops.neighborhood_similarity``: on the card the
forward and backward kernels, on the CPU the plain version. With
``img_trg`` in the tensors the loss also gives the JAX file's
``vis|density_sim_feat`` entry (a visualisation, never part of the
total): ``(img_trg, 1 - mean_k(ema_sim), ignore_trg)``, the density
(B, 1, H, W) and the target mask (B, 1, H, W) bool, from the similarity
the forward kernel already gave, detached.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ...ops import neighborhood_similarity, resize, unfold_neighbors
from ..builder import LOSSES
from .utils import masked_mean, masked_std


def _nearest(x, size):
    return resize(x, size=size, mode='nearest')


@LOSSES.register_module()
class PFGSTLoss:
    """Config-facing PFGST loss; ``__call__(tensors)`` -> loss dict."""

    def __init__(self,
                 top_k: Optional[int] = 3,
                 dilation: int = 2,
                 kernel_size: int = 3,
                 weights=None,
                 sigma: float = 30,
                 mean_sim: float = 0.6,
                 feat_level: Optional[int] = 2,
                 sim_type: str = 'gaussian',
                 num_bins: int = 100,
                 apply_ignore: bool = False,
                 src_perc: Optional[float] = None,
                 proj_net_cfg: Optional[dict] = None,
                 src_loss_type: str = 'mean_std',
                 margin: Sequence[float] = (0.5, 0.5),
                 detach_unfold: bool = False,
                 cross_prob_type: str = 'trg',
                 downscale: Optional[float] = None):
        # mean_sim, num_bins and apply_ignore are accepted for config
        # compatibility; as in the JAX file they change nothing
        del mean_sim, num_bins, apply_ignore
        if proj_net_cfg is not None:
            raise NotImplementedError('proj_net is not used by any shipped '
                                      'PFST config')
        if sim_type not in ('gaussian', 'cosine'):
            raise ValueError(f'unknown sim_type {sim_type}')
        if src_loss_type not in ('mean_std', 'margin', 'margin2'):
            raise ValueError(f'unknown src_loss_type {src_loss_type}')
        if cross_prob_type not in ('trg', 'ema'):
            raise ValueError(f'unknown cross_prob_type {cross_prob_type}')
        self.top_k = top_k
        self.dilation = dilation
        self.kernel_size = kernel_size
        if isinstance(weights, (list, tuple)):
            weights = {'sim_pos': weights[0], 'sim_neg': weights[1],
                       'src_pos': 0.0, 'src_neg': 0.0,
                       'src_pos_std': 0.0, 'src_neg_std': 0.0}
        self.weights = dict(weights or {})
        self.sigma = sigma
        self.feat_level = feat_level
        self.sim_type = sim_type
        self.src_perc = src_perc
        self.src_loss_type = src_loss_type
        self.margin = tuple(margin)
        self.detach_unfold = detach_unfold
        self.cross_prob_type = cross_prob_type
        self.downscale = downscale

    # -- pieces ----------------------------------------------------------
    def _unfold(self, x):
        return unfold_neighbors(x, self.kernel_size, self.dilation)

    def get_sim_feat(self, x, size):
        """(feats, sim): sim (B, k*k, H, W) fp32 (``pfgst_loss.py:95-109``)."""
        feats = _nearest(x, size)
        sim = neighborhood_similarity(feats, self.kernel_size, self.dilation,
                                      sim_type=self.sim_type,
                                      sigma=float(self.sigma))
        return feats, sim

    def get_cross_prob(self, logits_trg, logits_ema):
        """``sum_c p q`` agreement, (B, k*k, H, W)
        (``pfgst_loss.py:111-124``)."""
        p = torch.softmax(logits_trg, dim=1)
        q = p if self.cross_prob_type == 'trg' else torch.softmax(
            logits_ema, dim=1)
        unf_q = self._unfold(q)                       # (B, k2, C, H, W)
        if self.detach_unfold:
            unf_q = unf_q.detach()
        return (p[:, None] * unf_q).sum(dim=2)

    def _src_perc_mean(self, sims, mask, descending):
        """Mean of the bottom (ascending) or top (descending) ``src_perc``
        fraction of the masked sims (``pfgst_loss.py:126-140``)."""
        flat = sims.reshape(-1)
        m = mask.reshape(-1)
        fill = float('-inf') if descending else float('inf')
        vals = torch.where(m, flat, fill)
        order = torch.argsort(-vals if descending else vals, stable=True)
        ranks = torch.empty_like(order)
        ranks[order] = torch.arange(order.numel(), device=order.device)
        n_keep = (m.sum().float() * self.src_perc).long()
        return masked_mean(flat, (ranks < n_keep) & m)

    # -- forward ----------------------------------------------------------
    def __call__(self, tensors):
        k2 = self.kernel_size**2
        logits_trg = tensors['logits_trg']      # (B, C, h, w) head res
        logits_ema = tensors.get('logits_ema')
        gt_src = tensors['gt_src']              # (B, H0, W0) int
        x_ema = tensors['x_ema']
        x_src = tensors['x_src']
        if self.feat_level is not None:
            x_ema = x_ema[self.feat_level]
            x_src = x_src[self.feat_level]
        mix_masks = tensors['mix_masks']        # (B, H0, W0), 1 = source

        if self.downscale is not None:
            h = int(logits_trg.shape[2] * self.downscale)
            w = int(logits_trg.shape[3] * self.downscale)
            logits_trg = _nearest(logits_trg, (h, w))
        size = tuple(logits_trg.shape[2:])
        if logits_ema is not None and tuple(logits_ema.shape[2:]) != size:
            # the teacher's logits come at input resolution
            logits_ema = _nearest(logits_ema, size)

        gt = _nearest(gt_src[:, None].float(), size)     # (B, 1, H, W)
        ignore_src = gt[:, 0] != 255                      # (B, H, W)

        inv_mix = 1.0 - _nearest(mix_masks[:, None].float(), size)
        inv_mix = (inv_mix > 0.5).float()
        unf_inv = self._unfold(inv_mix)                   # (B, k2, 1, H, W)
        ignore_trg = unf_inv[:, :, 0].sum(dim=1) == k2    # (B, H, W)

        cross_prob_pos = self.get_cross_prob(logits_trg, logits_ema)
        cross_prob_neg = 1.0 - cross_prob_pos

        _, ema_sim = self.get_sim_feat(x_ema, size)
        _, src_sim = self.get_sim_feat(x_src, size)

        unf_gt = self._unfold(gt)[:, :, 0]                # (B, k2, H, W)
        src_valid = ignore_src[:, None]
        pos_mask = (unf_gt == gt) & src_valid
        neg_mask = (unf_gt != gt) & src_valid

        w = self.weights
        losses = {}
        if self.src_perc is not None:
            src_pos_mean = self._src_perc_mean(src_sim, pos_mask, False)
            src_neg_mean = self._src_perc_mean(src_sim, neg_mask, True)
        else:
            src_pos_mean = masked_mean(src_sim, pos_mask)
            src_neg_mean = masked_mean(src_sim, neg_mask)
        if self.src_loss_type == 'mean_std':
            losses['loss_src_pos_mean'] = -src_pos_mean * w.get('src_pos', 0.0)
            losses['loss_src_neg_mean'] = src_neg_mean * w.get('src_neg', 0.0)
            losses['loss_src_pos_std'] = masked_std(
                src_sim, pos_mask) * w.get('src_pos_std', 0.0)
            losses['loss_src_neg_std'] = masked_std(
                src_sim, neg_mask) * w.get('src_neg_std', 0.0)
        else:
            pos_h = torch.clamp(self.margin[0] - src_sim, min=0.0)
            neg_h = torch.clamp(src_sim - self.margin[1], min=0.0)
            if self.src_loss_type == 'margin2':
                pos_h, neg_h = pos_h**2, neg_h**2
            losses['loss_src_pos'] = masked_mean(pos_h, pos_mask) * \
                w.get('src_pos', 0.0)
            losses['loss_src_neg'] = masked_mean(neg_h, neg_mask) * \
                w.get('src_neg', 0.0)

        # -- target similarity pull/push -------------------------------
        valid_center = ignore_src & ignore_trg            # (B, H, W)
        if self.top_k is not None:
            top_sim, top_idx = ema_sim.topk(self.top_k + 1, dim=1)
            min_sim, min_idx = ema_sim.topk(self.top_k, dim=1,
                                            largest=False)
            loc_pos = top_sim * -cross_prob_pos.gather(1, top_idx)
            loc_neg = (1.0 - min_sim) * -cross_prob_neg.gather(1, min_idx)
        else:
            loc_pos = ema_sim * -cross_prob_pos
            loc_neg = (1.0 - ema_sim) * -cross_prob_neg
        vc = valid_center[:, None]
        gate = (valid_center.sum() > 1).float()
        losses['loss_sim_pos'] = masked_mean(
            loc_pos, vc.expand_as(loc_pos)) * gate * w.get('sim_pos', 0.0)
        losses['loss_sim_neg'] = masked_mean(
            loc_neg, vc.expand_as(loc_neg)) * gate * w.get('sim_neg', 0.0)
        img_trg = tensors.get('img_trg')
        if img_trg is not None:
            # ``pfgst_loss.py:250-254``
            losses['vis|density_sim_feat'] = (
                img_trg, 1.0 - ema_sim.detach().mean(dim=1, keepdim=True),
                ignore_trg[:, None])
        return losses
