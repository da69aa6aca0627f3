from .inference import init_segmentor
from .test import _finalize_views, make_inference_fn, make_state_fn

__all__ = ['init_segmentor', 'make_inference_fn', 'make_state_fn',
           '_finalize_views']
