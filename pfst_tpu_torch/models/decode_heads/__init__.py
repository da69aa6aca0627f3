from .aspp_head import ASPPHead, DepthwiseSeparableASPPHead
from .fcn_head import FCNHead
from .psp_head import PPM, adaptive_avg_pool
from .uper_head import UPerHead

__all__ = ['ASPPHead', 'DepthwiseSeparableASPPHead', 'FCNHead', 'PPM',
           'adaptive_avg_pool', 'UPerHead']
