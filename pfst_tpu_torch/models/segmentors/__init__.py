from .cascade_encoder_decoder import CascadeEncoderDecoder
from .domain_adaptor import (AdvTrainState, DomainAdaptor, DomainAdaptorAdv,
                             DomainAdaptorV2, FMDAAdaptor, FMDAAdaptorV2)
from .encoder_decoder import EncoderDecoder

__all__ = ['CascadeEncoderDecoder', 'EncoderDecoder', 'AdvTrainState',
           'DomainAdaptor', 'DomainAdaptorAdv', 'DomainAdaptorV2',
           'FMDAAdaptor', 'FMDAAdaptorV2']
