"""The PGST family (port of ``pfst_tpu/models/uda/pgst.py``).

* ``PGST``: PFGST's step with the teacher's ``feat_level`` map
  ClassMix-blended with the student's detached source map before the aux
  losses (``mix_ema_feat_level``);
* ``PGSTTRG``: target self-training on the pipeline's strong view as it
  is, against the raw pseudo-labels;
* ``PGSTV4``: PGST without the blend;
* ``PGSTMixFeat``: a second teacher forward on the weak mix (the same
  masks and draws on the plain target view) feeds the aux losses.
"""
from __future__ import annotations

from ..builder import UDA
from .pfgst import PFGST


@UDA.register_module()
class PGST(PFGST):

    def __init__(self, **cfg):
        cfg.setdefault('use_decoded_feats', False)
        super().__init__(**cfg)
        # the reference default (``pgst.py:22``)
        self.feat_level = cfg.get('feat_level', 2)

    @property
    def mix_ema_feat_level(self):
        return self.feat_level


@UDA.register_module()
class PGSTTRG(PFGST):
    target_self_training = True
    self_training_view = 'pipeline_strong'

    def __init__(self, **cfg):
        cfg.setdefault('use_decoded_feats', False)
        super().__init__(**cfg)


@UDA.register_module()
class PGSTV4(PGST):
    mix_ema_feat_level = None


@UDA.register_module()
class PGSTMixFeat(PGST):
    mix_feat_teacher_forward = True
    mix_ema_feat_level = None
