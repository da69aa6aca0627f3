from . import backbones, decode_heads, segmentors  # noqa: F401  (register)
from .builder import (BACKBONES, HEADS, MODELS, NECKS, SEGMENTORS,
                      build_backbone, build_head, build_neck,
                      build_segmentor)

__all__ = [
    'MODELS', 'BACKBONES', 'NECKS', 'HEADS', 'SEGMENTORS',
    'build_backbone', 'build_neck', 'build_head', 'build_segmentor'
]
