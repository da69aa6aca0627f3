from .aspp_head import ASPPHead, DepthwiseSeparableASPPHead
from .fcn_head import FCNHead

__all__ = ['ASPPHead', 'DepthwiseSeparableASPPHead', 'FCNHead']
