from .resnet import ResNet, ResNetV1c, ResNetV1d
from .vit import VisionTransformer

__all__ = ['ResNet', 'ResNetV1c', 'ResNetV1d', 'VisionTransformer']
