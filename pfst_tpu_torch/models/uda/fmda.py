"""FMDA (port of ``pfst_tpu/models/uda/fmda.py``).

* ``FMDA``: target self-training without ClassMix: the plain target view,
  jittered and blurred on the step's draws, trained against the
  teacher's pseudo-labels (losses prefixed ``trg``), with the aux losses;
* ``FMDAMix``: PGST's step (the blend at ``feat_level``, default 2) with
  ClassMix blending the plain target view.
"""
from __future__ import annotations

from ..builder import UDA
from .pfgst import PFGST
from .pgst import PGST


@UDA.register_module()
class FMDA(PFGST):
    target_self_training = True

    def __init__(self, **cfg):
        cfg.setdefault('use_decoded_feats', False)
        super().__init__(**cfg)


@UDA.register_module()
class FMDAMix(PGST):
    mix_view = 'target'

    def __init__(self, **cfg):
        cfg.setdefault('feat_level', 2)
        super().__init__(**cfg)
