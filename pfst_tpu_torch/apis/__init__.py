from .inference import init_segmentor
from .test import _finalize_views, make_inference_fn, make_state_fn
from .train import SupervisedTrainer, build_algorithm

__all__ = ['init_segmentor', 'make_inference_fn', 'make_state_fn',
           '_finalize_views', 'SupervisedTrainer', 'build_algorithm']
