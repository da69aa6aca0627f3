from .checkpoint import (extract_student, find_latest_checkpoint,
                         load_checkpoint, load_weights_into_state,
                         restore_state, save_checkpoint)
from .convert import (jax_variables_to_state_dict, load_jax_train_state,
                      torch_key_to_flax)
from .optimizers import ScheduledOptimizer, build_lr_schedule, build_optimizer

__all__ = ['extract_student', 'find_latest_checkpoint', 'load_checkpoint',
           'load_weights_into_state', 'restore_state',
           'save_checkpoint',
           'jax_variables_to_state_dict', 'load_jax_train_state',
           'torch_key_to_flax', 'ScheduledOptimizer', 'build_lr_schedule',
           'build_optimizer']
