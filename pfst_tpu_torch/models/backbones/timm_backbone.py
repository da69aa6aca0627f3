"""timm adapter (port of ``pfst_tpu/models/backbones/timm_backbone.py``).

As in the JAX file, a timm model name resolves to a registered backbone
(``_TIMM_MAP``), held as ``inner``; an unknown name raises with the
table. No timm and nothing downloaded. The inner backbone's keys sit
under ``backbone.inner``, the JAX tree's ``backbone_mod/inner``
(``key_family`` ``timm:<the inner backbone's family>``).
"""
from __future__ import annotations

from typing import Any, Optional

import torch.nn as nn

from ..builder import BACKBONES, build_backbone

_TIMM_MAP = {
    'resnet18': dict(type='ResNet', depth=18),
    'resnet34': dict(type='ResNet', depth=34),
    'resnet50': dict(type='ResNet', depth=50),
    'resnet101': dict(type='ResNet', depth=101),
    'resnest50d': dict(type='ResNeSt', depth=50),
    'mobilenetv2_100': dict(type='MobileNetV2'),
    'mobilenetv3_large_100': dict(type='MobileNetV3', arch='large'),
    'swin_tiny_patch4_window7_224': dict(type='SwinTransformer'),
    'vit_base_patch16_224': dict(type='VisionTransformer'),
}


@BACKBONES.register_module()
class TIMMBackbone(nn.Module):
    """A registered backbone under a timm model name (``timm_backbone.py:
    31-55``)."""

    def __init__(self, model_name: str = 'resnet50',
                 features_only: bool = True, pretrained: Optional[Any] = None,
                 in_channels: int = 3, init_cfg: Optional[dict] = None,
                 norm_cfg: Optional[dict] = None):
        super().__init__()
        del features_only, pretrained, in_channels, init_cfg
        if model_name not in _TIMM_MAP:
            raise KeyError(
                f'timm model {model_name!r} has no registered equivalent; '
                f'extend _TIMM_MAP in pfst_tpu_torch/models/backbones/'
                f'timm_backbone.py. Known: {sorted(_TIMM_MAP)}')
        cfg = dict(_TIMM_MAP[model_name])
        if norm_cfg is not None:
            cfg.setdefault('norm_cfg', norm_cfg)
        self.inner = build_backbone(cfg)
        self.key_family = 'timm:' + (getattr(self.inner, 'key_family', None)
                                     or '')
        if hasattr(self.inner, 'feature_channels'):
            self.feature_channels = self.inner.feature_channels

    def forward(self, x):
        return self.inner(x)
