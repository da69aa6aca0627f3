"""Local-similarity statistics (port of
``pfst_tpu/core/hooks/plot_statistics_hook.py``; mirrors
``rsiseg/core/hook/plot_statistics_hook.py:29-``).

``similarity_histogram`` bins the gaussian (with ``sigma``) or cosine
neighborhood similarities of a feature map through
``ops.neighborhood_similarity``, the hand-written kernel on the card.
The hooks sum it over a few validation batches after an evaluation and
plot it with matplotlib, which they import only there (a missing one is
a warning). They read ``ctx['val_loader']``, which the train loop does
not set (nor does the JAX loop), so in the loop they return at once
(ROADMAP C2).
"""
from __future__ import annotations

import os
import os.path as osp

import numpy as np
import torch

from ...ops import neighborhood_similarity
from ...utils.logger import get_root_logger
from .hook import HOOKS, Hook


def similarity_histogram(feats, kernel_size=3, dilation=2, sigma=None,
                         num_bins=100):
    """(counts, bin_edges) of the neighborhood similarities of ``feats``
    (B, C, H, W), over ``num_bins`` bins of [-1, 1]."""
    with torch.no_grad():
        if sigma is not None:
            sim = neighborhood_similarity(feats, kernel_size, dilation,
                                          'gaussian', float(sigma))
        else:
            sim = neighborhood_similarity(feats, kernel_size, dilation,
                                          'cosine')
    vals = sim.float().cpu().numpy().reshape(-1)
    hist, edges = np.histogram(vals, bins=num_bins, range=(-1.0, 1.0))
    return hist, edges


@HOOKS.register_module()
class PlotStatisticsHook(Hook):

    def __init__(self, log_dir, sim_feat_cfg=None, data_cfg=None,
                 interval=1, num_batches=4, **kwargs):
        self.log_dir = log_dir
        self.sim_feat_cfg = sim_feat_cfg or {}
        self.interval = interval
        self.num_batches = num_batches

    def after_eval(self, ctx, metrics):
        state = ctx.get('state')
        loader = ctx.get('val_loader')
        if ctx.get('algo') is None or state is None or loader is None:
            return
        os.makedirs(self.log_dir, exist_ok=True)
        model = state.student
        device = next(model.parameters()).device
        was_training = model.training
        model.eval()
        hists = []
        try:
            for bi, batch in enumerate(loader):
                if bi >= self.num_batches:
                    break
                img = batch['img']
                if isinstance(img, list):
                    img = img[0]
                with torch.no_grad():
                    _, states = model.encode_decode(
                        torch.as_tensor(img).to(device))
                hist, edges = similarity_histogram(
                    states['decoded_features'],
                    kernel_size=self.sim_feat_cfg.get('kernel_size', 3),
                    dilation=self.sim_feat_cfg.get('dilation', 2),
                    sigma=self.sim_feat_cfg.get('sigma'))
                hists.append(hist)
        finally:
            model.train(was_training)
        if not hists:
            return
        total = np.sum(hists, axis=0)
        try:
            import matplotlib
            matplotlib.use('Agg')
            import matplotlib.pyplot as plt
            fig, ax = plt.subplots()
            ax.bar(edges[:-1], total, width=np.diff(edges))
            ax.set_xlabel('neighborhood similarity')
            step = ctx.get('iter', 0)
            fig.savefig(osp.join(self.log_dir, f'sim_hist_{step}.png'))
            plt.close(fig)
        except Exception as e:  # noqa: BLE001 - as the JAX hook: warn
            get_root_logger().warning(f'plot skipped: {e}')


@HOOKS.register_module()
class PlotMultiClassStatisticsHook(PlotStatisticsHook):
    """per-class variant (``plot_statistics_hook.py``, multi-class)."""
