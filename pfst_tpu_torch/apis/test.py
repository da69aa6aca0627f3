"""Evaluation API, per-image half (port of ``pfst_tpu/apis/test.py``).

``make_inference_fn`` gives pre-softmax logits at input size,
``_finalize_views`` turns a request's views into its label map, and
``make_state_fn`` extracts the feature state (neighborhood similarity of
the decoded features, reference ``apis/test.py:160-191``). Images are
NCHW tensors on the model's device. ``single_gpu_test`` and the
multi-device test wait for the datasets.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops import neighborhood_similarity, resize


def make_inference_fn(model):
    """img (NCHW) -> pre-softmax logits (NCHW) at input size. View
    finalization rescales the LOGITS to the original shape and softmaxes
    after, the reference's TTA order (``encoder_decoder.py:284-310``)."""

    @torch.inference_mode()
    def infer(img):
        logits, _ = model.inference_logits(img)
        return logits

    return infer


def make_state_fn(model, sim_cfg: Optional[dict] = None):
    """img -> feature state: the decoded features, their neighborhood
    similarity (``sim_cfg`` defaults: k=3, d=2, gaussian, sigma=30) and
    the logits. On the card the similarity runs the CUDA kernel."""
    sim_cfg = sim_cfg or {}

    @torch.inference_mode()
    def states(img):
        _, st = model.encode_decode(img)
        feats = st['decoded_features']
        sim = neighborhood_similarity(
            feats, sim_cfg.get('kernel_size', 3),
            sim_cfg.get('dilation', 2),
            sim_type=sim_cfg.get('sim_type', 'gaussian'),
            sigma=float(sim_cfg.get('sigma', 30.0)))
        return {'decoded_features': feats, 'sim_feat': sim,
                'seg_logits': st['seg_logits']}

    return states


@torch.inference_mode()
def _view_probs(model, view_logits, metas, ori_shape) -> torch.Tensor:
    """Sum over a request's views of the softmax of each view's logits,
    flips undone and rescaled to ``ori_shape``; (1, K, H, W) fp32."""
    acc = None
    for logits, meta in zip(view_logits, metas):
        if meta.get('flip', False):
            dirs = meta.get('flip_direction') or []
            dirs = dirs if isinstance(dirs, list) else [dirs]
            for d in dirs:
                logits = torch.flip(logits,
                                    dims=(3 if d == 'horizontal' else 2,))
        if tuple(logits.shape[2:]) != tuple(ori_shape):
            logits = resize(logits, size=ori_shape, mode='bilinear',
                            align_corners=model.align_corners)
        probs = torch.softmax(logits.float(), dim=1)
        acc = probs if acc is None else acc + probs
    return acc


def _finalize_views(model, view_logits, metas, ori_shape) -> np.ndarray:
    """Undo TTA flips, rescale each view's LOGITS to ``ori_shape``,
    softmax, sum and argmax, in the order of the JAX file
    (``test.py:97-118``): the label map (H, W) as numpy."""
    acc = _view_probs(model, view_logits, metas, ori_shape)
    return acc.argmax(dim=1)[0].cpu().numpy()
