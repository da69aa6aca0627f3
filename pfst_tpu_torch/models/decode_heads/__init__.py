from .aspp_head import ASPPHead, DepthwiseSeparableASPPHead
from .attention_heads import DAHead, GCHead, NLHead
from .context_heads import (ANNHead, APCHead, DMHead, DNLHead, EMAHead,
                            OCRHead)
from .enc_head import EncHead
from .fcn_head import DepthwiseSeparableFCNHead, FCNHead, FPNHead
from .isa_cc_heads import CCHead, ISAHead, PSAHead
from .lraspp_head import LRASPPHead
from .point_rend import (DPTHead, IterativeDecodeHead, KernelUpdateHead,
                         KernelUpdator, PointRendHead, STDCHead,
                         calculate_uncertainty)
from .psp_head import PPM, PSPHead, adaptive_avg_pool
from .segformer_head import SegformerHead
from .transformer_heads import (SegmenterMaskTransformerHead, SETRMLAHead,
                                SETRUPHead)
from .uper_head import UPerHead

__all__ = ['ANNHead', 'APCHead', 'ASPPHead', 'CCHead', 'DAHead',
           'DepthwiseSeparableASPPHead', 'DepthwiseSeparableFCNHead',
           'DMHead', 'DNLHead', 'DPTHead', 'EMAHead', 'EncHead', 'FCNHead',
           'FPNHead', 'GCHead', 'ISAHead', 'IterativeDecodeHead',
           'KernelUpdateHead', 'KernelUpdator', 'OCRHead', 'PointRendHead',
           'STDCHead', 'calculate_uncertainty', 'LRASPPHead', 'NLHead', 'PSAHead',
           'PPM', 'PSPHead', 'adaptive_avg_pool',
           'SegformerHead', 'SegmenterMaskTransformerHead', 'SETRMLAHead',
           'SETRUPHead', 'UPerHead']
