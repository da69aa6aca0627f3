from .pfgst import PFGST, parse_losses
from .uda_decorator import (UDADecorator, UDATrainState, batch_stats_forward,
                            maybe_normalize_images)

__all__ = ['PFGST', 'parse_losses', 'UDADecorator', 'UDATrainState',
           'batch_stats_forward', 'maybe_normalize_images']
