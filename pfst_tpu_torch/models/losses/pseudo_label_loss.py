"""PseudoLabelLoss and LocalPseudoFeatLoss (port of
``pfst_tpu/models/losses/pseudo_label_loss.py``), on NCHW tensors.

The reference files are development code that cannot run (live
``pdb.set_trace()`` calls, the nonexistent ``F.cross_entropy_loss``); the
JAX file realises their documented intent on the tensors-dict interface
of the UDA layer's aux losses, and this file ports it. Both read keys
that the PFGST family's tensors carry (``logits_ema``, ``x_ema``).

``LocalPseudoFeatLoss`` takes its similarities through the PFST loss's
``_sim_feat``: on the card the forward kernel, and its backward for the
student's source map, whose gradient flows; on the CPU the plain version.
``torch.topk`` may order equal similarities otherwise than
``jax.lax.top_k`` (ROADMAP C2).
"""
from __future__ import annotations

import torch

from ...ops import resize, unfold_neighbors
from ..builder import LOSSES
from .cross_entropy_loss import cross_entropy
from .pfst_loss import _sim_feat
from .utils import masked_mean


@LOSSES.register_module()
class PseudoLabelLoss:
    """CE of the student's target logits against the hard pseudo-labels
    of the teacher's (``logits_ema``, bilinearly resized to the student's
    size where they differ; ``pseudo_label_loss.py:21-46``)."""

    def __init__(self, loss_type='entropy', weights=None, **kwargs):
        self.loss_type = loss_type
        self._loss_name = f'loss_{loss_type}'
        self.weights = weights or {}

    @property
    def loss_name(self):
        return self._loss_name

    def __call__(self, tensors):
        logits_trg = tensors['logits_trg']
        logits_ema = tensors['logits_ema'].detach()
        if logits_ema.shape[2:] != logits_trg.shape[2:]:
            logits_ema = resize(logits_ema, size=logits_trg.shape[2:],
                                mode='bilinear', align_corners=False)
        pseudo = logits_ema.argmax(dim=1)
        loss = cross_entropy(logits_trg, pseudo, ignore_index=255)
        return {'loss_pseudo': loss * self.weights.get('loss_pseudo', 1.0)}


@LOSSES.register_module()
class LocalPseudoFeatLoss:
    """The source same / different-label contrast of the student's
    similarities, and the target's local agreement over the teacher's
    ``top_k + 1`` most similar neighbours (``pseudo_label_loss.py:
    49-103``)."""

    def __init__(self, top_k, dilation, kernel_size, weights,
                 num_classes=None, sigma=30, mean_sim=0.6, feat_level=2,
                 sim_type='cosine'):
        del num_classes, mean_sim   # accepted for the configs, as in JAX
        self.top_k = top_k
        self.dilation = dilation
        self.kernel_size = kernel_size
        self.weights = weights
        self.sigma = sigma
        self.feat_level = feat_level
        self.sim_type = sim_type

    def _sim(self, x, size):
        return _sim_feat(x, size, self.kernel_size, self.dilation,
                         self.sim_type, self.sigma)[1]

    def __call__(self, tensors):
        logits_trg = tensors['logits_trg']               # (B, C, H, W)
        x_src, x_ema = tensors['x_src'], tensors['x_ema']
        if self.feat_level is not None:
            x_src, x_ema = x_src[self.feat_level], x_ema[self.feat_level]
        k, d = self.kernel_size, self.dilation
        size = tuple(logits_trg.shape[2:])
        gt = resize(tensors['gt_src'][:, None].float(), size=size,
                    mode='nearest')                      # (B, 1, H, W)
        valid = gt != 255
        src_sim = self._sim(x_src, size)                 # (B, k2, H, W)
        unf_gt = unfold_neighbors(gt, k, d)[:, :, 0]     # (B, k2, H, W)
        pos = (unf_gt == gt) & valid
        neg = (unf_gt != gt) & valid
        w = self.weights
        losses = {
            'loss_src_pos': -masked_mean(src_sim, pos) * w['src_pos'],
            'loss_src_neg': masked_mean(src_sim, neg) * w['src_neg'],
        }
        # target: pull the locally most similar pixels toward agreement
        ema_sim = self._sim(x_ema, size)
        p = torch.softmax(logits_trg, dim=1)
        unf_p = unfold_neighbors(p, k, d)                # (B, k2, C, H, W)
        agree = (p[:, None] * unf_p).sum(dim=2)          # (B, k2, H, W)
        top_sim, top_idx = ema_sim.topk(self.top_k + 1, dim=1)
        top_agree = agree.gather(1, top_idx)
        losses['loss_sim_pos'] = masked_mean(
            top_sim * -top_agree, torch.ones_like(top_sim, dtype=torch.bool)
        ) * w['sim_pos']
        return losses
