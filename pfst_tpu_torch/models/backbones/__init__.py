from .beit import BEiT, MAE
from .mit import MiT, MixVisionTransformer
from .resnet import ResNet, ResNetV1c, ResNetV1d
from .swin import SwinTransformer
from .twins import PCPVT, SVT
from .vit import VisionTransformer

__all__ = ['BEiT', 'MAE', 'MiT', 'MixVisionTransformer', 'PCPVT', 'ResNet',
           'ResNetV1c', 'ResNetV1d', 'SVT', 'SwinTransformer',
           'VisionTransformer']
