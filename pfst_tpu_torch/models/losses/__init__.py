from .accuracy import accuracy
from .adv_loss import AdvLoss
from .cross_entropy_loss import (CrossEntropyLoss, binary_cross_entropy,
                                 cross_entropy)
from .dice_loss import DiceLoss
from .entropy_loss import EntropyLoss, prob2ent
from .feat_sim_loss import (AdaptiveFeatSimLoss, AdaptiveFeatSimLossV2,
                            AdaptiveFeatSimLossV3, AdaptiveFeatSimLossV4,
                            FeatSimLoss, FeatSimLossV2,
                            MultiScaleAdaptiveFeatSimLoss)
from .focal_loss import FocalLoss
from .lovasz_loss import LovaszLoss
from .pfgst_loss import PFGSTLoss
from .pfst_loss import PFSTLoss, PFSTLossV2, PFSTLossV4
from .pseudo_label_loss import LocalPseudoFeatLoss, PseudoLabelLoss
from .utils import (get_class_weight, masked_mean, masked_std, reduce_loss,
                    weight_reduce_loss)

__all__ = [
    'accuracy', 'AdvLoss', 'EntropyLoss', 'prob2ent', 'PseudoLabelLoss',
    'LocalPseudoFeatLoss', 'CrossEntropyLoss', 'cross_entropy',
    'binary_cross_entropy', 'DiceLoss', 'FocalLoss', 'LovaszLoss',
    'PFGSTLoss', 'PFSTLoss', 'PFSTLossV2', 'PFSTLossV4', 'FeatSimLoss',
    'FeatSimLossV2', 'AdaptiveFeatSimLoss', 'AdaptiveFeatSimLossV2',
    'AdaptiveFeatSimLossV3', 'AdaptiveFeatSimLossV4',
    'MultiScaleAdaptiveFeatSimLoss', 'get_class_weight', 'reduce_loss',
    'weight_reduce_loss', 'masked_mean', 'masked_std'
]
