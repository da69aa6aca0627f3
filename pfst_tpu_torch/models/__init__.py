from . import backbones, decode_heads, losses, necks, segmentors, uda  # noqa: F401
from .builder import (BACKBONES, HEADS, LOSSES, MODELS, NECKS, SEGMENTORS,
                      UDA, build_backbone, build_head, build_loss, build_neck,
                      build_segmentor, build_train_model)

__all__ = [
    'MODELS', 'BACKBONES', 'NECKS', 'HEADS', 'LOSSES', 'SEGMENTORS', 'UDA',
    'build_backbone', 'build_neck', 'build_head', 'build_loss',
    'build_segmentor', 'build_train_model'
]
