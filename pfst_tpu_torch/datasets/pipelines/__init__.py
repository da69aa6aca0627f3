from .compose import Compose
from .formatting import Collect, DefaultFormatBundle, ImageToTensor
from .loading import (LoadAnnotations, LoadAnnotationsPseudoLabelsV2,
                      LoadImageFromFile, imread)
from .test_time_aug import MultiScaleFlipAug
from .transforms import (DeferNormalize, Normalize, Pad,
                         PhotoMetricDistortion, RandomCrop, RandomFlip,
                         RandomRotate90, Resize, StrongAugmentation)

__all__ = [
    'Compose', 'Collect', 'DefaultFormatBundle', 'ImageToTensor',
    'LoadImageFromFile', 'LoadAnnotations', 'LoadAnnotationsPseudoLabelsV2',
    'imread', 'MultiScaleFlipAug', 'Resize', 'RandomCrop', 'RandomFlip',
    'RandomRotate90', 'Pad', 'Normalize', 'DeferNormalize',
    'PhotoMetricDistortion', 'StrongAugmentation'
]
