from .beit import BEiT, MAE
from .resnet import ResNet, ResNetV1c, ResNetV1d
from .swin import SwinTransformer
from .vit import VisionTransformer

__all__ = ['BEiT', 'MAE', 'ResNet', 'ResNetV1c', 'ResNetV1d',
           'SwinTransformer', 'VisionTransformer']
