from .dacs import DACS
from .fmda import FMDA, FMDAMix
from .pfgst import PFGST, parse_losses
from .pfst import PFST, PFSTV2, PFSTV3, PFSTV4
from .pgst import PGST, PGSTV4, PGSTMixFeat, PGSTTRG
from .uda_decorator import (UDADecorator, UDATrainState, batch_stats_forward,
                            maybe_normalize_images)

__all__ = [
    'PFGST', 'PFST', 'PFSTV2', 'PFSTV3', 'PFSTV4', 'DACS', 'PGST',
    'PGSTTRG', 'PGSTV4', 'PGSTMixFeat', 'FMDA', 'FMDAMix', 'parse_losses',
    'UDADecorator', 'UDATrainState', 'batch_stats_forward',
    'maybe_normalize_images'
]
