"""Pseudo-labelling hooks (port of
``pfst_tpu/core/hooks/pseudo_labeling_hook.py``; mirrors
``rsiseg/core/hook/pseudo_labeling_hookv4.py:28-278``).

The corpus generator is ``apis/pseudo_labels.py`` (its command line
``tools/gen_pseudo_labels_torch.py``); these hooks schedule one run of it
from a training config, on the latest checkpoint of the run's
``work_dir``, and then halt the loop as the reference does: at
``trigger_iter`` they raise ``_StopTraining``, which ``train_segmentor``
takes as the end of training; with ``trigger_iter <= 0`` they generate at
the end of the run instead. The JAX loop halts on any ``ValueError`` a
hook raises; the port halts only on ``_StopTraining`` and lets every other
exception propagate (ROADMAP C2).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ...parallel.mesh import get_dist_info
from ..checkpoint import find_latest_checkpoint
from .hook import HOOKS, Hook


class _StopTraining(ValueError):
    """Raised to halt the train loop after generation: the reference's
    deliberate ValueError ('stop training after generating pseudo
    labels')."""


@HOOKS.register_module()
class PseudoLabelingHookV4(Hook):
    """Generate the pseudo-label corpus at ``trigger_iter``, then halt.

    ``out_dir`` is the corpus directory, ``split`` the data split to label,
    ``save_feats`` / ``feat_levels`` the backbone levels to store (and to
    compute similarity maps of), ``target_mean_sim`` the sigma search's
    target; the reference runs on its ``interval``, this hook once.
    """

    def __init__(self, out_dir, split='test', save_feats=False,
                 feat_levels=(2, 3), target_mean_sim=0.6,
                 trigger_iter=0, **kwargs):
        self.out_dir = out_dir
        self.split = split
        self.save_feats = save_feats
        self.feat_levels = tuple(feat_levels)
        self.target_mean_sim = target_mean_sim
        self.trigger_iter = int(trigger_iter)

    # every rank halts at ``trigger_iter``; rank 0 writes the corpus
    all_ranks = True

    def _generate(self, ctx: Dict[str, Any]):
        rank, world = get_dist_info()
        if rank == 0:
            self._write_corpus(ctx)
        if world > 1:
            torch.distributed.barrier()

    def _write_corpus(self, ctx: Dict[str, Any]):
        from ...apis.pseudo_labels import generate_pseudo_labels
        work_dir = ctx.get('work_dir') or '.'
        ckpt = find_latest_checkpoint(work_dir)
        if ckpt is None:
            raise _StopTraining(
                'PseudoLabelingHook: no checkpoint found to label from')
        state = ctx.get('state')
        device = next(state.student.parameters()).device \
            if state is not None else 'cuda'
        generate_pseudo_labels(
            ctx['cfg'], ckpt, self.out_dir, split=self.split,
            save_feats=self.save_feats, feat_levels=self.feat_levels,
            mean_sim=(self.target_mean_sim,), device=device)

    def after_train_iter(self, ctx, log_vars, vis_states=None):
        if int(ctx.get('iter', 0)) >= self.trigger_iter > 0:
            self._generate(ctx)
            raise _StopTraining(
                'pseudo labels generated; halting training '
                '(reference behavior: pseudo_labeling_hookv4.py)')

    def after_run(self, ctx):
        if self.trigger_iter <= 0:
            self._generate(ctx)


@HOOKS.register_module()
class PseudoLabelingHook(PseudoLabelingHookV4):
    """V1 (``pseudo_labeling_hook.py``): the same public workflow."""


@HOOKS.register_module()
class PseudoLabelingHookV2(PseudoLabelingHookV4):
    """V2: the same public workflow."""


@HOOKS.register_module()
class PseudoLabelingHookV3(PseudoLabelingHookV4):
    """V3: the same public workflow."""
