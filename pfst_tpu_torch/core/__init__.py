from .convert import (jax_variables_to_state_dict, load_jax_train_state,
                      torch_key_to_flax)
from .optimizers import ScheduledOptimizer, build_lr_schedule, build_optimizer

__all__ = ['jax_variables_to_state_dict', 'load_jax_train_state',
           'torch_key_to_flax', 'ScheduledOptimizer', 'build_lr_schedule',
           'build_optimizer']
