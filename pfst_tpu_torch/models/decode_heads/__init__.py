from .aspp_head import ASPPHead, DepthwiseSeparableASPPHead
from .context_heads import ANNHead
from .fcn_head import DepthwiseSeparableFCNHead, FCNHead, FPNHead
from .lraspp_head import LRASPPHead
from .point_rend import DPTHead
from .psp_head import PPM, PSPHead, adaptive_avg_pool
from .segformer_head import SegformerHead
from .transformer_heads import (SegmenterMaskTransformerHead, SETRMLAHead,
                                SETRUPHead)
from .uper_head import UPerHead

__all__ = ['ANNHead', 'ASPPHead', 'DepthwiseSeparableASPPHead',
           'DepthwiseSeparableFCNHead', 'DPTHead', 'FCNHead', 'FPNHead',
           'LRASPPHead', 'PPM', 'PSPHead', 'adaptive_avg_pool',
           'SegformerHead', 'SegmenterMaskTransformerHead', 'SETRMLAHead',
           'SETRUPHead', 'UPerHead']
