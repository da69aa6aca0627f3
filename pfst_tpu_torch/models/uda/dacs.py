"""DACS (port of ``pfst_tpu/models/uda/dacs.py``): PFGST's step without
the aux losses by default, ClassMix blending the plain target view
(``dacs.py:29``), with the optional feature distance to a frozen copy of
the initial student (``imnet_feature_dist_lambda``)."""
from __future__ import annotations

from ..builder import UDA
from .pfgst import PFGST


@UDA.register_module()
class DACS(PFGST):
    mix_view = 'target'

    def __init__(self, **cfg):
        cfg.setdefault('aux_losses', None)
        cfg.setdefault('use_decoded_feats', False)
        cfg.setdefault('thre_type', 'all')
        super().__init__(**cfg)
