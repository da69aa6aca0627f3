"""Feature2Pyramid neck on NCHW maps (port of
``pfst_tpu/models/necks/necks.py:86-102``).

As in the JAX file, and unlike mmseg's deconvolution pyramid, it only
resizes: each input by its rescale (4, 2, 1, 0.5 for BEiT and MAE),
bilinear with ``align_corners=False`` and no antialiasing (the JAX
resize's, ``pfst_tpu/ops/resize.py:10``). It has no parameters;
``embed_dim`` and ``norm_cfg`` are accepted and unused.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch.nn as nn

from ...ops import resize
from ..builder import NECKS


@NECKS.register_module()
class Feature2Pyramid(nn.Module):

    def __init__(self, embed_dim: int = 768,
                 rescales: Sequence[float] = (4, 2, 1, 0.5),
                 norm_cfg: Optional[dict] = None):
        super().__init__()
        del embed_dim, norm_cfg
        self.rescales = tuple(rescales)

    def forward(self, inputs):
        return tuple(
            x if s == 1 else resize(x, scale_factor=s, mode='bilinear',
                                    align_corners=False)
            for x, s in zip(inputs, self.rescales))
