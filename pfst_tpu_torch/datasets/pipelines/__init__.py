from .compose import Compose
from .formatting import Collect, DefaultFormatBundle, ImageToTensor
from .h5 import UnsupportedH5, read_h5, write_h5
from .loading import (AnnotationMapperInria, LoadAnnotations,
                      LoadAnnotationsDepth, LoadAnnotationsGTA,
                      LoadAnnotationsPseudoLabels,
                      LoadAnnotationsPseudoLabelsV2, LoadImageFromFile,
                      imread)
from .test_time_aug import MultiScaleFlipAug
from .transforms import (CLAHE, AdjustGamma, ClipNormalize, DeferNormalize,
                         KeepOriImage, MultiDomainClipNormalize, Normalize,
                         Pad, PercentileNormalize, PhotoMetricDistortion,
                         RandomCrop, RandomFlip, RandomRotate, RandomRotate90,
                         Rerange, Resize, RGB2Gray, SegRescale,
                         StrongAugmentation, Uint82Float)

__all__ = [
    'Compose', 'Collect', 'DefaultFormatBundle', 'ImageToTensor',
    'LoadImageFromFile', 'LoadAnnotations', 'LoadAnnotationsPseudoLabels',
    'LoadAnnotationsPseudoLabelsV2', 'read_h5', 'write_h5', 'UnsupportedH5',
    'imread', 'MultiScaleFlipAug', 'Resize', 'RandomCrop', 'RandomFlip',
    'RandomRotate90', 'Pad', 'Normalize', 'DeferNormalize',
    'PhotoMetricDistortion', 'StrongAugmentation', 'ClipNormalize',
    'Uint82Float', 'KeepOriImage', 'RandomRotate', 'PercentileNormalize',
    'MultiDomainClipNormalize', 'Rerange', 'CLAHE', 'RGB2Gray',
    'AdjustGamma', 'SegRescale', 'AnnotationMapperInria',
    'LoadAnnotationsGTA', 'LoadAnnotationsDepth'
]
