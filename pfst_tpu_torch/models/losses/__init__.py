from .accuracy import accuracy
from .cross_entropy_loss import (CrossEntropyLoss, binary_cross_entropy,
                                 cross_entropy)
from .pfgst_loss import PFGSTLoss
from .utils import (get_class_weight, masked_mean, masked_std, reduce_loss,
                    weight_reduce_loss)

__all__ = [
    'accuracy', 'CrossEntropyLoss', 'cross_entropy', 'binary_cross_entropy',
    'PFGSTLoss', 'get_class_weight', 'reduce_loss', 'weight_reduce_loss',
    'masked_mean', 'masked_std'
]
