from .encoder_decoder import EncoderDecoder

__all__ = ['EncoderDecoder']
