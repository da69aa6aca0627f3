from .beit import BEiT, MAE
from .convnext import ConvNeXt
from .fast_cnns import (BiSeNetV1, BiSeNetV2, CGNet, ERFNet, FastSCNN, ICNet,
                        STDCContextPathNet, STDCNet)
from .hrnet import HRNet
from .mit import MiT, MixVisionTransformer
from .mobilenet import MobileNetV2, MobileNetV3
from .resnest import ResNeSt
from .resnet import ResNet, ResNetV1c, ResNetV1d
from .resnext import ResNeXt
from .swin import SwinTransformer
from .timm_backbone import TIMMBackbone
from .twins import PCPVT, SVT
from .unet import UNet
from .vit import VisionTransformer

__all__ = ['BEiT', 'BiSeNetV1', 'BiSeNetV2', 'CGNet', 'ConvNeXt', 'ERFNet',
           'FastSCNN', 'HRNet', 'ICNet', 'MAE', 'MiT', 'MixVisionTransformer',
           'MobileNetV2', 'MobileNetV3', 'PCPVT', 'ResNeSt', 'ResNeXt',
           'ResNet', 'ResNetV1c', 'ResNetV1d', 'STDCContextPathNet', 'STDCNet',
           'SVT', 'SwinTransformer', 'TIMMBackbone', 'UNet',
           'VisionTransformer']
