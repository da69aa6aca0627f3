"""Helpers shared by the ``test_torch_*`` parity tests: weights in the
JAX package's layout, made from a numpy seed, and carried into the port
through ``jax_variables_to_state_dict``."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from pfst_tpu_torch.core import jax_variables_to_state_dict


def jax_variables(model, shape, seed=0):
    """Variables for ``model`` (the tree ``model.init`` would give at the
    NHWC ``shape``, taken with ``eval_shape`` so nothing compiles), drawn
    from ``numpy.random.RandomState(seed)``. Conv kernels have std
    ``sqrt(2/fan_in)`` and norms scales below 1, so activations stay of
    order one through 50 layers; shifts, biases and running statistics
    are away from their init values, so eval-mode norms are not the
    identity."""
    shapes = jax.eval_shape(lambda: model.init(
        {'params': jax.random.PRNGKey(0)}, jnp.zeros(shape, jnp.float32)))
    rs = np.random.RandomState(seed)

    def draw(path, leaf):
        name, shp = path[-1].key, leaf.shape
        if name == 'kernel':
            fan_in = int(np.prod(shp[:-1]))
            out = rs.randn(*shp) * np.sqrt(2.0 / fan_in)
        elif name == 'scale':
            out = rs.uniform(0.5, 1.0, shp)
        elif name == 'var':
            out = rs.uniform(0.5, 1.5, shp)
        else:   # bias, mean
            out = 0.1 * rs.randn(*shp)
        return np.asarray(out, np.float32)

    return jax.tree_util.tree_map_with_path(draw, dict(shapes))


def load_port(port_model, variables):
    """Load JAX ``variables`` into ``port_model``; return it in eval mode."""
    port_model.load_state_dict(
        jax_variables_to_state_dict(variables, port_model.state_dict()))
    return port_model.eval()


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)
