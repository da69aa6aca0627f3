"""The port's spatially sharded training (``pfst_tpu_torch/parallel/
spatial.py``) against the JAX mode on virtual devices and against the
port's single-process step over the global batch, on the CPU.

gloo ranks of the port (``tests/torch_dist_worker.py``: processes without
JAX, one thread each, started once a module, every join and collective
limited to 120 s) run two jobs, two ranks and four, while the JAX mode
compiles once: ``make_spatial_train_step`` on a (data 2, spatial 2) mesh
of 4 virtual devices, the tiny PFGST step of ``tests/test_spatial.py``
(``_tiny_uda_algo``: ``conftest.tiny_model_cfg``, ``PFGSTLoss``, SGD 1e-2,
a 64 x 32 batch of 2), de-randomised as ``tests/test_torch_train.py``
does it (dropout 0, jitter probability 1.0, the ClassMix scores the JAX
step draws), its weights ``torch_parity.jax_variables`` at step 3 with a
perturbed teacher.

* (a) The window ops on ``Stripe`` blocks forward and backward
  (``StripeNet``: a conv, train-mode BN, max-pool, a conv of dilation 12,
  the image pool with its BN on the whole pooled map, bilinear resizes)
  against the whole map, at 2 ranks, on a 2 x 2 grid, and at 4 ranks
  along the height, where the dilation reads the rows of the block two
  away: the output, the input's and the weights' gradients, the running
  statistics.
* (b) The port's step at sp 2, at sp 2 x spw 2 and at data 2 x sp 2
  against the JAX mode (all three compute the single-device step): log
  vars atol 1e-4 (``acc_seg`` 0.5), post-step parameters, EMA parameters
  and BN statistics atol 2e-5 (the JAX test's bars), the running
  variance through torch's n/(n-1) (ROADMAP C2).
* The step with the heads' dropout on, at sp 2 and at data 2 x sp 2,
  against the port's single-process step (each block's mask cut from the
  global map's): rtol 1e-3, atol 3e-5. One step: from this state a second
  one multiplies the first one's rounding by ten in the stem, dropout or
  not, as the single-process step does to a 1e-6 change of its input.
* (c) ``train_segmentor`` with ``parallel.sp=2`` on two ranks equals the
  single-process loop of the tiny leaf config on every rank; ``--sp``
  reaches ``cfg.parallel.sp``.
* (d) The refusals, with the JAX messages.
"""
import os.path as osp
import sys

import numpy as np
import pytest
import torch

# torch's OpenMP pool must not run beside XLA-CPU in one process
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from conftest import tiny_model_cfg  # noqa: E402
from test_spatial import _uda_batch  # noqa: E402
from test_torch_zero_tp import LOOP_ITERS, _loop_root  # noqa: E402
from torch_dist_worker import (MEAN, STD, StripeNet, join_ranks,  # noqa: E402
                               start_ranks)
from torch_parity import (FAST_COMPILE, jax_variables, nchw,  # noqa: E402
                          shared_by_workers, shared_dir,
                          two_pass_batch_variance)

from pfst_tpu.core import optimizers as jax_opt  # noqa: E402
from pfst_tpu.models import build_train_model as jax_train_model  # noqa: E402
from pfst_tpu.models.uda import uda_decorator as jax_uda  # noqa: E402
from pfst_tpu.parallel import spatial as jax_spatial  # noqa: E402
from pfst_tpu_torch.apis import build_algorithm  # noqa: E402
from pfst_tpu_torch.apis.train import _gspmd_layout  # noqa: E402
from pfst_tpu_torch.core import (build_optimizer,  # noqa: E402
                                 jax_variables_to_state_dict,
                                 load_jax_train_state)
from pfst_tpu_torch.parallel.spatial import (SpatialLayout,  # noqa: E402
                                             shard_spatial_batch)
from pfst_tpu_torch.utils import Config  # noqa: E402

sys.path.insert(0, osp.join(osp.dirname(__file__), '..', 'tools'))
import train_torch  # noqa: E402

SGD = dict(type='SGD', lr=1e-2)
# four images, not two: in train mode the ASPP image pool's BN normalizes
# one value an image and channel, and over two images some channel's
# variance falls to BN's eps, where the step's gradient moves by percents
# for a 1e-6 change of the input (the JAX mode itself is then 5e-5 off
# the JAX single-device step); test_torch_train.py's batch is four too
BATCH = 4
START_STEP = 3
GRIDS = [(2, 1), (2, 2), (4, 1)]
# (name, sp, spw, world): the layouts held to the JAX mode
LAYOUTS = [('sp2', 2, 1, 2), ('sp2_spw2', 2, 2, 4), ('data2_sp2', 2, 1, 4)]
TOL = dict(rtol=1e-3, atol=3e-5)


def _uda_cfg(dropout):
    """``_tiny_uda_algo``'s config, de-randomised (module docstring);
    with ``dropout`` the heads' dropout of ``tiny_model_cfg`` on."""
    aux = [dict(type='PFGSTLoss', kernel_size=3, dilation=1, top_k=3,
                weights={'src_pos': 0.1, 'src_neg': 0.1, 'sim_pos': 0.1,
                         'sim_neg': 0.1, 'src_pos_std': 0.1,
                         'src_neg_std': 0.1},
                sim_type='cosine', feat_level=None, detach_unfold=True,
                downscale=0.5)]
    model = tiny_model_cfg()
    if not dropout:
        model['decode_head']['dropout_ratio'] = 0.0
        model['auxiliary_head']['dropout_ratio'] = 0.0
    return dict(
        uda=dict(type='PFGST', alpha=0.99, pseudo_threshold=0.9,
                 pseudo_weight_ignore_top=0, pseudo_weight_ignore_bottom=0,
                 imnet_feature_dist_lambda=0, mix='class', blur=False,
                 color_jitter_strength=0.2, color_jitter_probability=1.0,
                 use_decoded_feats=True, thre_type='all', aux_losses=aux),
        model=model, runner=dict(max_iters=10))


def _jax_case():
    """The JAX algorithm, optimizer and state at ``START_STEP`` (student
    and teacher from two seeds), and the batch."""
    algo = jax_train_model(_uda_cfg(False))
    student = jax_variables(algo.model, (1, 64, 32, 3), seed=0)
    rs = np.random.RandomState(1)
    teacher = jax.tree.map(
        lambda x: (x + 0.05 * rs.randn(*x.shape)).astype(np.float32),
        student)
    tx = jax_opt.build_optimizer(SGD)
    state = jax_uda.UDATrainState(
        params=student['params'], batch_stats=student['batch_stats'],
        ema_params=teacher['params'],
        ema_batch_stats=teacher['batch_stats'],
        opt_state=tx.init(student['params']),
        step=jnp.asarray(START_STEP, jnp.int32))
    batch = {k: np.asarray(v) for k, v in _uda_batch(b=BATCH).items()}
    return algo, tx, state, batch


def _jax_mode(algo, tx, state, batch, rng):
    """One step of the JAX mode on a (data 2, spatial 2) mesh."""
    mesh = jax_spatial.get_spatial_mesh(2, devices=jax.devices()[:4])
    assert dict(mesh.shape) == {'data': 2, 'spatial': 2}
    step = jax_spatial.make_spatial_train_step(algo, tx, MEAN, STD, mesh)
    sharded = jax_spatial.shard_spatial_batch(
        {k: jnp.asarray(v) for k, v in batch.items()}, mesh)
    placed = jax.device_put(state, NamedSharding(mesh, P()))
    with two_pass_batch_variance():
        compiled = step.lower(placed, sharded, rng).compile(FAST_COMPILE)
    new_state, log_vars, _ = compiled(placed, sharded, rng)
    return jax.device_get((new_state, log_vars))


def _class_scores(rng, b):
    """The ClassMix scores the JAX step draws from ``rng``
    (``pfgst.py:203``, ``dacs_transforms.py:59``)."""
    k_mix = jax.random.split(rng, 6)[2]
    return torch.from_numpy(np.stack([
        np.asarray(jax.random.uniform(k, (7,)))
        for k in jax.random.split(k_mix, b)]))


def _port_batch(batch):
    return {k: torch.from_numpy(v.astype(np.int64)) if v.ndim == 3
            else nchw(v) for k, v in batch.items()}


def _stripe_task():
    g = torch.Generator().manual_seed(5)
    net = StripeNet(12)
    with torch.no_grad():
        for name, p in net.named_parameters():
            p.copy_(0.5 + torch.rand(p.shape, generator=g)
                    if name.startswith(('bn', 'pool_bn')) and
                    name.endswith('weight')
                    else 0.3 * torch.randn(p.shape, generator=g))
    # one offset an image: the pooled map's BN sees two distinct values
    x = torch.randn(2, 3, 64, 32, generator=g) + torch.tensor(
        [0.5, -0.5]).view(2, 1, 1, 1)
    return dict(kind='stripe_grad', grids=GRIDS, dilation=12,
                weights=net.state_dict(), x=x,
                g=torch.randn(2, 4, 64, 32, generator=g))


@pytest.fixture(scope='module')
def sp(tmp_path_factory):
    """Every rank's results and the JAX mode's step, computed once."""
    def compute():
        directory = shared_dir(tmp_path_factory) / 'spatial_train_ranks'
        directory.mkdir(exist_ok=True)
        jalgo, tx, jstate, batch = _jax_case()
        # the mode's step donates the state it is given
        jstate = jax.device_get(jstate)
        rng = jax.random.PRNGKey(1)
        algo = build_algorithm(_uda_cfg(False), device='cpu')
        state = load_jax_train_state(jstate, algo.init_state(
            torch.Generator().manual_seed(0), build_optimizer(SGD)))
        base = dict(kind='spatial_step', cfg=_uda_cfg(False), opt=SGD,
                    step=START_STEP, batch=_port_batch(batch),
                    state={'student': state.student.state_dict(),
                           'teacher': state.teacher.state_dict()},
                    class_scores=_class_scores(rng, BATCH), gen_seeds=[7])
        drop = dict(base, cfg=_uda_cfg(True), class_scores=None,
                    gen_seeds=[8], single=True)
        grad = _stripe_task()
        # the single-process step with dropout once, on the two ranks
        jobs = {2: {'grad': grad, 'sp2_dropout': dict(drop, sp=2)},
                4: {'grad': grad,
                    'data2_sp2_dropout': dict(drop, sp=2, single=False)}}
        for name, n_h, n_w, world in LAYOUTS:
            jobs[world][name] = dict(base, sp=n_h, spw=n_w,
                                     single=name == 'sp2')
        jobs[2]['loop'] = dict(kind='gspmd_loop',
                               config=_loop_root(directory),
                               iters=LOOP_ITERS, parallel=dict(sp=2),
                               work_dir=str(directory / 'work'))
        procs = {}
        for world in (2, 4):
            (directory / str(world)).mkdir(exist_ok=True)
            procs[world] = start_ranks(jobs[world],
                                       str(directory / str(world)), world)
        try:
            ref = _jax_mode(jalgo, tx, jstate, batch, rng)
        finally:
            ranks = {w: join_ranks(p, str(directory / str(w)))
                     for w, p in procs.items()}
        return dict(ranks=ranks, ref=ref, jstate=jstate)

    return shared_by_workers(tmp_path_factory, 'spatial_train', compute)


def _results(sp, name):
    world = 2 if name in ('sp2', 'sp2_dropout', 'loop') else 4
    return [r[name] for r in sp['ranks'][world]]


# ------------------------------ (a) the blocks ------------------------------
def test_stripe_autograd_matches_the_whole_map(sp):
    """At every grid the gathered output, the input's and every weight's
    gradient (the ranks' partial gradients summed) and the running
    statistics (BN over every block; the pooled map's over the batch)
    equal the whole map's; every rank holds the same."""
    whole = sp['ranks'][2][0]['grad']['whole']
    scale = max(float(g.abs().max()) for g in whole['grads'].values())
    for grid in GRIDS:
        world = grid[0] * grid[1]
        for rank in sp['ranks'][world]:
            got = rank['grad'][grid]
            np.testing.assert_allclose(got['out'], whole['out'], rtol=1e-5,
                                       atol=1e-5, err_msg=f'{grid} output')
            assert sorted(got['grads']) == sorted(whole['grads'])
            for k, g in whole['grads'].items():
                np.testing.assert_allclose(
                    got['grads'][k], g, rtol=1e-4, atol=1e-5 * scale,
                    err_msg=f'{grid} gradient of {k}')
            for k, v in whole['stats'].items():
                np.testing.assert_allclose(got['stats'][k], v, rtol=1e-5,
                                           atol=1e-6,
                                           err_msg=f'{grid} {k}')


# ---------------------------- (b) against JAX -------------------------------
def _assert_close(got, want, what, **tol):
    assert sorted(got) == sorted(want), what
    for k, v in want.items():
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(v),
                                   err_msg=f'{what} {k}', **tol)


def test_step_matches_the_jax_mode(sp):
    """One step at each layout (sp 2; sp 2 x spw 2; data 2 x sp 2) against
    ``make_spatial_train_step`` on a (data 2, spatial 2) mesh: log vars,
    the student's parameters and BN statistics, the EMA teacher; every
    rank of a layout the same, bitwise. Each rank stepped on its own block
    of the batch."""
    new_state, log_vars = sp['ref']
    single = _results(sp, 'sp2')[0]
    jstate = sp['jstate']
    template = single['single'][1]['student']
    before = jax_variables_to_state_dict(
        {'params': jstate.params, 'batch_stats': jstate.batch_stats},
        template)
    after = jax_variables_to_state_dict(
        {'params': new_state.params, 'batch_stats': new_state.batch_stats},
        template)
    ema = jax_variables_to_state_dict(
        {'params': new_state.ema_params,
         'batch_stats': jstate.ema_batch_stats}, template)
    m = 0.1
    for layout, n_h, n_w, world in LAYOUTS:
        ranks = _results(sp, layout)
        got = ranks[0]
        n_data = world // (n_h * n_w)
        assert got['blocks']['img'] == (BATCH // n_data, 3, 64 // n_h,
                                        32 // n_w), layout
        assert sorted(got['logs'][0]) == sorted(log_vars), layout
        for k, v in log_vars.items():
            np.testing.assert_allclose(got['logs'][0][k], float(v),
                                       atol=0.5 if 'acc' in k else 1e-4,
                                       rtol=0, err_msg=f'{layout} {k}')
        student = got['modules']['student']
        for key, value in student.items():
            leaf = key.rsplit('.', 1)[1]
            if leaf == 'num_batches_tracked':
                continue
            want = after[key]
            if leaf == 'running_var':
                # two passes from v0: torch's c * v_jax - (c - 1)(1 - m)^2 v0
                c = single['counts'][key.rsplit('.', 1)[0]]
                c = c / (c - 1)
                want = c * want - (c - 1) * (1 - m)**2 * before[key]
            np.testing.assert_allclose(value, want, atol=2e-5, rtol=0,
                                       err_msg=f'{layout} {key}')
            if leaf not in ('running_mean', 'running_var'):
                np.testing.assert_allclose(got['modules']['teacher'][key],
                                           ema[key], atol=2e-5, rtol=0,
                                           err_msg=f'{layout} EMA {key}')
        for rank in ranks[1:]:
            assert rank['logs'] == got['logs'], layout
            for name, sd in got['modules'].items():
                for k, v in sd.items():
                    assert torch.equal(rank['modules'][name][k], v), \
                        (layout, name, k)


def test_steps_with_dropout_match_the_single_process_steps(sp):
    """A step with the heads' dropout on, at sp 2 and at data 2 x sp 2,
    against the port's single-process step over the global batch (every
    block's mask cut from the one the single-process step draws): every
    rank's log vars, the whole modules."""
    logs, modules = _results(sp, 'sp2_dropout')[0]['single']
    for case in ('sp2_dropout', 'data2_sp2_dropout'):
        for rank in _results(sp, case):
            for got, want in zip(rank['logs'], logs, strict=True):
                _assert_close(got, want, case, **TOL)
            for name, sd in modules.items():
                _assert_close(rank['modules'][name], sd, f'{case} {name}',
                              **TOL)


# ------------------------------- (c) the loop -------------------------------
def test_train_loop_at_sp2_is_the_single_process_loop(sp):
    """``train_segmentor`` with ``parallel.sp=2`` on two ranks (one data
    index: both take the whole batch, each a block of it) logs, on every
    rank, what the single-process loop logs, and its checkpoint holds the
    single-process loop's student."""
    ranks = _results(sp, 'loop')
    want = ranks[0]['single']
    for r in ranks:
        assert len(r['history']) == LOOP_ITERS
        for got, ref in zip(r['history'], want['history'], strict=True):
            _assert_close(got['log_vars'], ref['log_vars'], 'loop', **TOL)
    _assert_close(ranks[0]['ckpt'], want['ckpt'], 'checkpoint', **TOL)


def test_train_cli_sp_reaches_cfg_parallel(tmp_path):
    """``--sp N`` lands in ``cfg.parallel.sp`` over its other keys
    (``tests/test_spatial.py::test_train_cli_sp_flag_reaches_cfg``); spw
    comes through ``--cfg-options``."""
    cfg_file = tmp_path / 'c.py'
    cfg_file.write_text('parallel = dict(other=1)\nmodel = dict()\n')
    args = train_torch.parse_args([str(cfg_file), '--sp', '2',
                                   '--cfg-options', 'parallel.spw=2'])
    cfg = Config.fromfile(args.config)
    cfg.merge_from_dict(args.cfg_options)
    cfg.merge_from_dict(train_torch.parallel_options(args))
    assert dict(cfg.parallel) == dict(other=1, sp=2, spw=2)


# ------------------------------ (d) refusals --------------------------------
@pytest.mark.parametrize('other', [dict(tp=2), dict(zero=1),
                                   dict(zero=3)])
def test_sp_composes_with_data_parallelism_only(other):
    """``sp`` (or ``spw``) with ``tp`` or ``zero`` raises the JAX assert
    (``train.py:441-442``), with or without a process group."""
    for option in ('sp', 'spw'):
        cfg = Config(dict(parallel={option: 2, **other}))
        with pytest.raises(AssertionError,
                           match=r'parallel\.sp composes with dp only '
                                 r'\(not tp/zero\)'):
            _gspmd_layout(cfg, None)


def test_a_world_sp_does_not_divide_raises(monkeypatch):
    """A world ``sp`` x ``spw`` does not divide raises the JAX assert
    (``train.py:443-445``): six ranks at 2 x 2, and one process without a
    launcher at sp 2."""
    import torch.distributed as dist
    monkeypatch.setattr(dist, 'get_world_size', lambda group=None: 6)
    with pytest.raises(AssertionError,
                       match=r'^6 devices not divisible by parallel\.sp=2x '
                             r'spw=2$'):
        _gspmd_layout(Config(dict(parallel=dict(sp=2, spw=2))), object())
    monkeypatch.undo()
    with pytest.raises(AssertionError,
                       match=r'1 devices not divisible by parallel\.sp=2x '
                             r'spw=1'):
        _gspmd_layout(Config(dict(parallel=dict(sp=2))), None)


@pytest.mark.parametrize('key,hw,match', [
    ('img', (33, 32), r'img: H=33 not divisible by sp=2'),
    ('gt_semantic_seg', (64, 30), r'gt_semantic_seg: W=30 not divisible '
                                  r'by spw=4')])
def test_a_crop_sp_does_not_divide_raises(key, hw, match):
    """``shard_spatial_batch`` asserts as the JAX function does
    (``spatial.py:160-164``): a height ``sp`` does not divide, a width
    ``spw`` does not; 1-D tensors and scalars pass whole."""
    layout = SpatialLayout(None, None, None, 1, 2, 4, 0, 5)
    ok = {'img': torch.zeros(1, 3, 64, 32),
          'gt_semantic_seg': torch.zeros(1, 64, 32), 'w': torch.ones(3)}
    blocks = shard_spatial_batch(ok, layout)
    # position 5 of a 2 x 4 grid: row 1, column 1
    assert torch.equal(blocks['w'], ok['w'])
    assert blocks['img'].shape == (1, 3, 32, 8)
    bad = dict(ok)
    bad[key] = torch.zeros((1, 3) + hw if key == 'img' else (1,) + hw)
    with pytest.raises(AssertionError, match=match):
        shard_spatial_batch(bad, layout)
