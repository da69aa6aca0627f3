from .resnet import ResNet, ResNetV1c, ResNetV1d

__all__ = ['ResNet', 'ResNetV1c', 'ResNetV1d']
