"""Helpers shared by the ``test_torch_*`` parity tests: weights in the
JAX package's layout, made from a numpy seed, and carried into the port
through ``jax_variables_to_state_dict``."""
import contextlib
import fcntl
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pfst_tpu_torch.core import jax_variables_to_state_dict
from pfst_tpu_torch.core.convert import key_families

# XLA:CPU compile options for the tests' JAX programs, each of which runs
# once: LLVM's costly optimisations off (a PFGST train step of
# tiny_model_cfg compiles in ~7 s instead of ~11 s), same results within
# the parity tolerances
FAST_COMPILE = {'xla_backend_optimization_level': 0,
                'xla_llvm_disable_expensive_passes': True}


def shared_by_workers(tmp_path_factory, key, compute):
    """``compute()`` once a pytest run, also across pytest-xdist's
    workers (which each run a module fixture their tests need): the first
    worker to ask computes it under a file lock beside the workers'
    temporary directories and pickles it there; the others, and later
    asks, load that. The value must pickle: numpy arrays, not device
    arrays; paths to files written under ``shared_dir``."""
    root = shared_dir(tmp_path_factory)
    path = root / f'{key}.pkl'
    with open(root / f'{key}.lock', 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            with open(f'{path}.tmp', 'wb') as f:
                pickle.dump(compute(), f)
            os.replace(f'{path}.tmp', path)
    with open(path, 'rb') as f:
        return pickle.load(f)


def shared_dir(tmp_path_factory):
    """The run's temporary root, the same for every xdist worker."""
    root = tmp_path_factory.getbasetemp()
    return root.parent if os.environ.get('PYTEST_XDIST_WORKER') else root


def run_jit(fn, *args):
    """``jax.jit(fn)(*args)``, compiled with ``FAST_COMPILE``."""
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)(*args)


@contextlib.contextmanager
def two_pass_batch_variance():
    """While JAX traces under this context, flax's BatchNorm takes the
    batch variance as mean((x - mean)^2), as torch does, instead of its
    default E[x^2] - E[x]^2 (``use_fast_variance``), which loses digits in
    fp32 where a channel's mean is large against its spread: in train
    mode the ASPP image-pool BN sees one value per image, and at batch 2
    that puts the reference's logits ~2e-4 off an fp64 evaluation while
    the port's stay within 4e-5 (ROADMAP C2). The JAX package is not
    changed; its formula for the statistics is. flax offers no public
    route to that flag for a module built inside the JAX package, so this
    patches its private ``_compute_stats`` and fails if nothing traced
    under the context called the patch (a flax that no longer reaches it
    would otherwise leave the default formula in place unseen)."""
    from flax.linen import normalization

    compute_stats = normalization._compute_stats
    calls = []

    def two_pass(*args, **kwargs):
        calls.append(1)
        kwargs['use_fast_variance'] = False
        return compute_stats(*args, **kwargs)

    normalization._compute_stats = two_pass
    try:
        yield
    finally:
        normalization._compute_stats = compute_stats
    assert calls, ('no BatchNorm statistics were computed through the '
                   'patched flax normalization._compute_stats')


def jax_variables(model, shape, seed=0):
    """Variables for ``model`` (the tree ``model.init`` would give at the
    NHWC ``shape``, or at a tuple of inputs for a list of shapes, taken
    with ``eval_shape`` so nothing compiles), drawn
    from ``numpy.random.RandomState(seed)``. Conv kernels have std
    ``sqrt(2/fan_in)`` and norms scales below 1, so activations stay of
    order one through 50 layers; shifts, biases and running statistics
    are away from their init values, so eval-mode norms are not the
    identity."""
    x = tuple(jnp.zeros(s, jnp.float32) for s in shape) \
        if isinstance(shape, list) else jnp.zeros(shape, jnp.float32)
    shapes = jax.eval_shape(lambda: model.init(
        {'params': jax.random.PRNGKey(0)}, x))
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
    port_model.load_state_dict(jax_variables_to_state_dict(
        variables, port_model.state_dict(), **key_families(port_model)))
    return port_model.eval()


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)
