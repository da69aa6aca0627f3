from .inference import inference_segmentor, init_segmentor
from .test import (_finalize_views, make_inference_fn, make_state_fn,
                   multi_gpu_test, single_gpu_test)
from .train import (SupervisedTrainer, build_algorithm, init_random_seed,
                    set_random_seed, train_segmentor)

__all__ = ['init_segmentor', 'inference_segmentor', 'make_inference_fn',
           'make_state_fn', '_finalize_views', 'multi_gpu_test',
           'single_gpu_test',
           'SupervisedTrainer', 'build_algorithm', 'init_random_seed',
           'set_random_seed', 'train_segmentor']
