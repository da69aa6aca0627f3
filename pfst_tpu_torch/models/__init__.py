from . import (backbones, decode_heads, discriminators, losses,  # noqa: F401
               necks, segmentors, uda)
from .builder import (BACKBONES, DISCRIMINATORS, HEADS, LOSSES, MODELS,
                      NECKS, SEGMENTORS, UDA, build_backbone,
                      build_discriminator, build_head, build_loss,
                      build_neck, build_segmentor, build_train_model)

__all__ = [
    'MODELS', 'BACKBONES', 'NECKS', 'HEADS', 'LOSSES', 'SEGMENTORS',
    'DISCRIMINATORS', 'UDA', 'build_backbone', 'build_neck', 'build_head',
    'build_loss', 'build_discriminator',
    'build_segmentor', 'build_train_model'
]
