"""The port's GPipe (``pfst_tpu_torch/parallel/pp.py``) and expert-parallel
MoE (``parallel/ep.py``) against the JAX functions on virtual devices, on
the CPU.

Four gloo ranks of the port (``tests/torch_dist_worker.py``, started once
a module, every join and collective limited to 120 s) run: ``gpipe_apply``
of ``tests/test_pp.py``'s tanh block as 4 stages of 4 microbatches and as
2 stages of 8 (more microbatches than stages), forward and the gradients
of the sum of the output's squares; the port's ``ViTBlock`` as 4 stages
against the same blocks in sequence; ``moe_apply`` of ``tests/test_ep.py``'s
expert with 4 experts at ample capacity (and its gradients) and with 2
experts at capacity factor 0.5, every token routed to expert 0, the
dropped tokens zero. The JAX functions run on 4 or 2 virtual devices
while the ranks run. Tolerance 1e-5 (the JAX tests'); the gradients
rtol 1e-4, atol 1e-5 as ``tests/test_pp.py`` holds its own.
"""
import os.path as osp

import numpy as np
import pytest
import torch

# torch's OpenMP pool must not run beside XLA-CPU in one process
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_dist_worker import join_ranks, start_ranks  # noqa: E402
from torch_parity import run_jit, shared_by_workers, shared_dir  # noqa: E402

from pfst_tpu.parallel import ep as jax_ep  # noqa: E402
from pfst_tpu.parallel import pp as jax_pp  # noqa: E402
from pfst_tpu_torch.models.backbones.vit import ViTBlock  # noqa: E402
from pfst_tpu_torch.parallel.ep import top1_dispatch  # noqa: E402
from pfst_tpu_torch.parallel.pp import stack_stage_params  # noqa: E402

WORLD = 4
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _block(p, x):
    h = jnp.tanh(x @ p['w1'] + p['b1'])
    return x + h @ p['w2']


def _mlp_params(seed, n, c=16, hidden=32):
    rs = np.random.RandomState(seed)
    return [{'w1': (rs.randn(c, hidden) * 0.1).astype(np.float32),
             'b1': (rs.randn(hidden) * 0.1).astype(np.float32),
             'w2': (rs.randn(hidden, c) * 0.1).astype(np.float32)}
            for _ in range(n)]


def _gpipe_case(seed, stages, m, shape):
    params = _mlp_params(seed, stages)
    x = np.random.RandomState(seed + 1).randn(*shape).astype(np.float32)
    stacked = {k: np.stack([p[k] for p in params]) for k in params[0]}
    task = dict(kind='gpipe', stages=stages, m=m, x=torch.from_numpy(x),
                params={k: torch.from_numpy(v) for k, v in stacked.items()})

    def reference():
        mesh = jax_pp.get_pipe_mesh(stages)

        def loss(s, x):
            return jnp.sum(jax_pp.gpipe_apply(_block, s, x, mesh, m) ** 2)

        def both(s, x):
            return (jax_pp.gpipe_apply(_block, s, x, mesh, m),
                    jax.grad(loss, argnums=(0, 1))(s, x))

        out, (gs, gx) = run_jit(both, stacked, x)
        return jax.device_get((out, gs, gx))

    return task, reference


def _vit_case():
    """4 stages of the port's ViTBlock (16 wide, 2 heads): the stacked
    parameters and the blocks run in sequence, as the reference."""
    blocks = [ViTBlock(16, 2, 2) for _ in range(4)]
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for b in blocks:
            for p in b.parameters():
                p.copy_(torch.randn(p.shape, generator=g) * 0.2)
    x = torch.randn(4, 9, 16, generator=g)
    params = stack_stage_params([dict(b.named_parameters()) for b in blocks])
    xs = x.clone().requires_grad_()
    ref = xs
    for b in blocks:
        ref = b(ref)
    (ref ** 2).sum().backward()
    want = dict(out=ref.detach(), dx=xs.grad,
                grads=[{k: p.grad for k, p in b.named_parameters()}
                       for b in blocks])
    return dict(kind='gpipe', stages=4, m=2, x=x, vit=(16, 2, 2),
                params={k: v.detach() for k, v in params.items()}), want


def _moe_params(n, d=8, h=16, seed=0):
    rs = np.random.RandomState(seed)
    ps = [{'w': (rs.randn(d, h) * 0.3).astype(np.float32),
           'v': (rs.randn(h, d) * 0.3).astype(np.float32)} for _ in range(n)]
    return {k: np.stack([p[k] for p in ps]) for k in ps[0]}


def _moe_case(experts, tokens, cf, seed, route_to_zero=False):
    stacked = _moe_params(experts, seed=seed)
    rs = np.random.RandomState(seed + 7)
    gate = rs.randn(8, experts).astype(np.float32)
    x = rs.randn(tokens, 8).astype(np.float32)
    if route_to_zero:
        gate[:] = 0.0
        gate[-1, 0], gate[-1, 1] = 10.0, -10.0
        x[:, -1] = 1.0
    task = dict(kind='moe', experts=experts, cf=cf, x=torch.from_numpy(x),
                gate=torch.from_numpy(gate),
                params={k: torch.from_numpy(v) for k, v in stacked.items()})

    def expert(p, t):
        return jnp.tanh(t @ p['w']) @ p['v']

    def reference():
        mesh = jax_ep.get_expert_mesh(experts)

        def loss(s, g):
            return jnp.sum(jax_ep.moe_apply(expert, s, x, g, mesh, cf) ** 2)

        def both(s, g):
            return (jax_ep.moe_apply(expert, s, x, g, mesh, cf),
                    jax.grad(loss, argnums=(0, 1))(s, g))

        out, (gs, gg) = run_jit(both, stacked, gate)
        return jax.device_get((out, gs, gg))

    return task, reference


@pytest.fixture(scope='module')
def blocks(tmp_path_factory):
    def compute():
        directory = shared_dir(tmp_path_factory) / 'pp_ep_ranks'
        directory.mkdir(exist_ok=True)
        cases = {'gpipe4': _gpipe_case(0, 4, 4, (8, 10, 16)),
                 'gpipe2': _gpipe_case(4, 2, 8, (16, 4, 16)),
                 'moe4': _moe_case(4, 64, 8.0, 0),
                 'moe_drop': _moe_case(2, 16, 0.5, 3, route_to_zero=True)}
        vit_task, vit_want = _vit_case()
        job = {k: t for k, (t, _) in cases.items()}
        job['vit'] = vit_task
        procs = start_ranks(job, str(directory), WORLD)
        try:
            refs = {k: ref() for k, (_, ref) in cases.items()}
        finally:
            ranks = join_ranks(procs, str(directory))
        return dict(ranks=ranks, refs=refs, vit=vit_want)

    return shared_by_workers(tmp_path_factory, 'pp_ep', compute)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


@pytest.mark.parametrize('case', ['gpipe4', 'gpipe2'])
def test_gpipe_matches_jax(blocks, case):
    """The output on every rank of the pipe, the input's gradient on
    every rank, and each stage's parameters' gradient against the JAX
    schedule's."""
    out, grads, gx = blocks['refs'][case]
    stages = len(next(iter(grads.values())))
    ranks = [r[case] for r in blocks['ranks'][:stages]]
    for r in ranks:
        _close(r['out'], out)
        _close(r['dx'], gx, GRAD_TOL)
    for d, r in enumerate(ranks):
        for k, g in grads.items():
            _close(r['grads'][k], g[d], GRAD_TOL)
    # ranks beyond the pipe took no part
    assert all(r[case] is None for r in blocks['ranks'][stages:])


def test_gpipe_of_vit_blocks_matches_the_sequential_stack(blocks):
    """4 stages of ViTBlock, 2 microbatches: output, input gradient and
    each block's parameter gradients equal the blocks run in sequence."""
    want = blocks['vit']
    for d, r in enumerate(r['vit'] for r in blocks['ranks']):
        _close(r['out'], want['out'])
        _close(r['dx'], want['dx'], GRAD_TOL)
        for k, g in want['grads'][d].items():
            _close(r['grads'][k], g, GRAD_TOL)


def test_gpipe_refuses_a_stage_count_other_than_the_ranks(tmp_path):
    """The stacked stages must be the pipe's ranks (``pp.py:64-69``), and
    a pipe of more stages than ranks raises."""
    import torch.distributed as dist
    from pfst_tpu_torch.parallel import pp
    store = osp.join(str(tmp_path), 'store')
    dist.init_process_group('gloo', init_method=f'file://{store}', rank=0,
                            world_size=1)
    try:
        with pytest.raises(ValueError, match='3 stacked stages'):
            pp.gpipe_apply(lambda p, x: x, {'w': torch.zeros(3, 2)},
                           torch.zeros(2, 2), dist.group.WORLD, 1)
        with pytest.raises(ValueError, match='2 pipeline stages need 2'):
            pp.get_pipe_group(2)
    finally:
        dist.destroy_process_group()


def test_moe_matches_jax_and_the_dense_computation(blocks):
    """4 experts, 64 tokens, ample capacity: each rank's tokens out as
    JAX's, the experts' and the gate's gradients as JAX's (the gate's
    summed over the ranks, as the replicated gate's is)."""
    out, gs, gg = blocks['refs']['moe4']
    ranks = [r['moe4'] for r in blocks['ranks']]
    _close(torch.cat([r['out'] for r in ranks]), out)
    for e, r in enumerate(ranks):
        for k, g in gs.items():
            _close(r['grads'][k], g[e], GRAD_TOL)
    _close(sum(r['gate_grad'] for r in ranks), gg, GRAD_TOL)


def test_moe_capacity_drops_come_out_zero(blocks):
    """Every token routed to expert 0 at capacity factor 0.5 (2 slots a
    rank of 8 tokens): the first 2 tokens of each rank as JAX's, the rest
    exactly zero."""
    out, _, _ = blocks['refs']['moe_drop']
    ranks = [r['moe_drop'] for r in blocks['ranks'][:2]]
    for e, r in enumerate(ranks):
        want = out[e * 8:(e + 1) * 8]
        _close(r['out'], want)
        _close(r['out'][:2], want[:2])
        assert float(r['out'][2:].abs().max()) == 0.0


def test_top1_dispatch_is_the_jax_routing():
    """The dispatch one-hot and gate against the JAX function's, with
    drops."""
    logits = np.random.RandomState(9).randn(12, 3).astype(np.float32)
    gate, disp = top1_dispatch(torch.from_numpy(logits), 2)
    jgate, jdisp = jax_ep.top1_dispatch(jnp.asarray(logits), 2)
    _close(gate, jgate)
    np.testing.assert_array_equal(disp.numpy(), np.asarray(jdisp))
    assert disp.sum() < 12
