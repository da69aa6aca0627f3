"""The PFST variants (port of ``pfst_tpu/models/uda/pfst.py``).

``PFST`` is PFGST's step with the backbone features feeding the
similarity losses; ``PFSTV2`` and ``PFSTV3`` train as PFST. ``PFSTV4``
runs the teacher on the un-augmented target view ``target_img_ori`` and
replays the batch's recorded rot90 / flips (``rotate_k``,
``flip_vertical``, ``flip_horizontal``) onto its outputs: the logits and
the ``feat_level`` map (``pfst.py:68-100``). Replaying them onto the
teacher's input instead would differ: a CNN is not rot90-equivariant, and
the teacher is meant to predict on the un-rotated view.
"""
from __future__ import annotations

import torch

from ..builder import UDA
from ..utils.pfst_transforms import transform_by_metas
from .pfgst import PFGST
from .uda_decorator import UDATrainState

REPLAY_KEYS = ('rotate_k', 'flip_vertical', 'flip_horizontal')


@UDA.register_module()
class PFST(PFGST):

    def __init__(self, **cfg):
        cfg.setdefault('use_decoded_feats', False)
        cfg.setdefault('thre_type', 'all')
        cfg.setdefault('apply_no_mix', False)
        super().__init__(**cfg)


@UDA.register_module()
class PFSTV2(PFST):
    """PFST's training (the reference's V2 differs in a rendering
    threshold only)."""


@UDA.register_module()
class PFSTV3(PFST):
    """PFST's training (the reference's V3 adds an unused copy of the
    replay)."""


@UDA.register_module()
class PFSTV4(PFST):

    def __init__(self, **cfg):
        super().__init__(**cfg)
        # the reference default (``pfst.py:68-69``)
        self.feat_level = cfg.get('feat_level', 2)

    @torch.no_grad()
    def teacher_and_mix(self, state: UDATrainState, batch: dict,
                        draws: dict, mean, std, teacher_out=None) -> dict:
        if teacher_out is None and 'target_img_ori' in batch:
            ori = batch['target_img_ori']
            metas = {k: batch[k] for k in REPLAY_KEYS if k in batch}
            ema_logits, ema_feats = self.teacher_forward(state, ori)
            img_h = ori.shape[2]
            ema_logits = transform_by_metas(ema_logits, metas, scale=1.0)
            if isinstance(ema_feats, (tuple, list)):
                # only the similarity losses' level, as the reference
                feats = list(ema_feats)
                lvl = self.feat_level
                feats[lvl] = transform_by_metas(
                    feats[lvl], metas, scale=feats[lvl].shape[2] / img_h)
                ema_feats = tuple(feats)
            else:
                ema_feats = transform_by_metas(
                    ema_feats, metas, scale=ema_feats.shape[2] / img_h)
            teacher_out = (ema_logits, ema_feats)
        return super().teacher_and_mix(state, batch, draws, mean, std,
                                       teacher_out=teacher_out)
