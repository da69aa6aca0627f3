from .convert import jax_variables_to_state_dict, torch_key_to_flax

__all__ = ['jax_variables_to_state_dict', 'torch_key_to_flax']
