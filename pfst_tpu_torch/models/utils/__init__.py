from .layers import (ConvModule, DepthwiseSeparableConvModule, Norm,
                     build_act, norm_name)

__all__ = ['ConvModule', 'DepthwiseSeparableConvModule', 'Norm',
           'build_act', 'norm_name']
