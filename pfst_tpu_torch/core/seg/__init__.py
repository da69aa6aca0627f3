from .sampler import (BasePixelSampler, OHEMPixelSampler, PIXEL_SAMPLERS,
                      build_pixel_sampler)

__all__ = ['BasePixelSampler', 'OHEMPixelSampler', 'PIXEL_SAMPLERS',
           'build_pixel_sampler']
