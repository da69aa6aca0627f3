"""The port's GSPMD modes, ZeRO-1/3 (``pfst_tpu_torch/parallel/zero.py``)
and tensor parallelism (``parallel/tp.py``), against the JAX modes on
virtual devices and against the port's own single-process step over the
global batch, on the CPU.

gloo ranks of the port (``tests/torch_dist_worker.py``: processes without
JAX, one thread each, started once a module, every join and collective
limited to 120 s) run two jobs: two ranks (ZeRO-1, ZeRO-3 with a whole
checkpoint and its resume, tp 2, PFGST under ZeRO-1 and ZeRO-3, the train
loop at tp 2) and four (tp 2 x ZeRO-1 on a 2 x 2 layout, the loop at tp 2
x ZeRO-3). The JAX modes compile while they run: ``make_zero_train_step``
at levels 1 and 3 on 2 devices, ``make_tp_train_step`` on a (1, 2) mesh
and the two composed on a (2, 2) mesh, on the supervised step of
``tests/test_zero.py``'s tiny ViT (2 layers, 32 wide, 32², dropout 0),
SGD with momentum (the moments ZeRO shards) at batch 4.

* Each mode's step equals the JAX mode: log vars, post-step parameters
  and BN statistics (torch's running variance is unbiased over the
  global count), rtol 1e-3, atol 3e-5.
* Each mode's steps equal the port's single-process steps over the
  global batch at the same tolerances: two steps of the ViT with the
  head's dropout on (its masks drawn for the global batch), and PFGST
  (``print_grad_magnitude``: the whole batch's ``grad_mag``) on the
  golden traces' narrow ResNet under ZeRO-1 and ZeRO-3.
* The sharded leaves (``tree_specs``, ``zero_specs``) are the JAX sets by
  JAX path; the bytes the ranks store sum to JAX's audit.
* A ZeRO-3 checkpoint is whole: it loads into the single-process port,
  which steps on as the sharded run does, and into a fresh sharded state.
* The loop: ``train_segmentor`` at tp 2 on two ranks equals the
  single-process run of the tiny leaf config on every rank; at tp 2 x
  ZeRO-3 on four ranks every rank logs the same and the checkpoint loads
  into the single-process port.
* The refusals of what waits and the CLI flags.
"""
import copy
import os.path as osp
import sys

import numpy as np
import pytest
import torch

# torch's OpenMP pool must not run beside XLA-CPU in one process
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

from test_torch_ddp import _images, _labels  # noqa: E402
from test_torch_ddp import _model_cfg as cnn_cfg  # noqa: E402
from test_torch_loop import tiny_config  # noqa: E402
from test_uda_golden_trace import _uda_cfg as pfgst_uda_cfg  # noqa: E402
from test_zero import _cnn_cfg as vit_cfg  # noqa: E402
from torch_dist_worker import MEAN, STD, join_ranks, start_ranks  # noqa: E402
from torch_parity import (FAST_COMPILE, jax_variables, nchw,  # noqa: E402
                          shared_by_workers, shared_dir,
                          two_pass_batch_variance)

from pfst_tpu.apis.train import SupervisedTrainer as JaxSupervised  # noqa: E402
from pfst_tpu.core import optimizers as jax_opt  # noqa: E402
from pfst_tpu.models import build_segmentor as jax_segmentor  # noqa: E402
from pfst_tpu.models.uda import uda_decorator as jax_uda  # noqa: E402
from pfst_tpu.parallel import tp as jax_tp  # noqa: E402
from pfst_tpu.parallel import zero as jax_zero  # noqa: E402
from pfst_tpu_torch.apis import build_algorithm, init_segmentor  # noqa: E402
from pfst_tpu_torch.apis.train import (BLOCK_PARALLEL,  # noqa: E402
                                       _gspmd_layout, _refuse_waiting)
from pfst_tpu_torch.core import (build_optimizer,  # noqa: E402
                                 jax_variables_to_state_dict,
                                 load_jax_train_state)
from pfst_tpu_torch.core.convert import key_families  # noqa: E402
from pfst_tpu_torch.models import build_segmentor  # noqa: E402
from pfst_tpu_torch.parallel.zero import _zero_dim  # noqa: E402
from pfst_tpu_torch.utils import Config  # noqa: E402

sys.path.insert(0, osp.join(osp.dirname(__file__), '..', 'tools'))
import make_synthetic_data_torch  # noqa: E402
import pack_dataset_torch  # noqa: E402
import train_torch  # noqa: E402

B, HW = 4, 32
SGD = dict(type='SGD', lr=1e-2, momentum=0.9)
TOL = dict(rtol=1e-3, atol=3e-5)
LOOP_ITERS = 2
# (name, tp, zero, world)
MODES = [('zero1', 1, 1, 2), ('zero3', 1, 3, 2), ('tp2', 2, 0, 2),
         ('tp2_zero1', 2, 1, 4)]


def _vit(dropout=0.0):
    cfg = vit_cfg()
    cfg['decode_head']['dropout_ratio'] = dropout
    return cfg


def _batch(seed, hw=HW):
    rs = np.random.RandomState(seed)
    img = rs.randn(B, 3, hw, hw).astype(np.float32)
    gt = rs.randint(0, 6, (B, hw, hw))
    gt[0, :4] = 255
    return {'img': torch.from_numpy(img), 'gt_semantic_seg':
            torch.from_numpy(gt)}


def _vit_case():
    """The JAX supervised state of the tiny ViT and the port's copy."""
    jmodel = jax_segmentor(_vit())
    variables = jax_variables(jmodel, (1, HW, HW, 3), seed=2)
    tx = jax_opt.build_optimizer(SGD)
    jstate = jax_uda.UDATrainState(
        params=variables['params'], batch_stats=variables['batch_stats'],
        ema_params={}, ema_batch_stats={},
        opt_state=tx.init(variables['params']),
        step=jnp.zeros((), jnp.int32))
    algo = build_algorithm(dict(model=_vit()), device='cpu')
    state = load_jax_train_state(jstate, algo.init_state(
        torch.Generator().manual_seed(0), build_optimizer(SGD)))
    return jmodel, tx, jstate, state.student.state_dict()


def _mesh(n, n_model=1):
    devs = np.asarray(jax.devices()[:n]).reshape(n // n_model, n_model)
    return Mesh(devs, ('data', 'model'))


def _jax_mode(jmodel, tx, jstate, batch, tp, zero):
    """One JAX step of the mode, its memory audit and specs."""
    algo = JaxSupervised(jmodel)
    n = 4 if tp > 1 and zero else 2
    mesh = _mesh(n, tp)
    rules = jax_tp.DEFAULT_TP_RULES
    if zero:
        state = jax_zero.shard_state(jstate, mesh, rules if tp > 1 else None,
                                     level=zero)
        step = jax_zero.make_zero_train_step(
            algo, tx, MEAN, STD, mesh, rules if tp > 1 else None,
            level=zero)
        put = jax_zero.shard_batch
    else:
        state = jax_tp.shard_state(jstate, mesh)
        step = jax_tp.make_tp_train_step(algo, tx, MEAN, STD, mesh)
        put = jax_tp.shard_batch_2d
    jb = put({'img': jnp.asarray(batch['img'].numpy().transpose(0, 2, 3, 1)),
              'gt_semantic_seg': jnp.asarray(
                  batch['gt_semantic_seg'].numpy().astype(np.int32))}, mesh)

    def moment_bytes(opt_state):
        stored = whole = 0
        for x in jax.tree.leaves(opt_state):
            if getattr(x, 'ndim', 0):
                stored += sum(s.data.nbytes for s in x.addressable_shards)
                whole += x.nbytes * len(x.sharding.device_set)
        return stored, whole

    audit = dict(opt=moment_bytes(state.opt_state),
                 params=jax_zero.tree_bytes(state.params))
    rng = jax.random.PRNGKey(7)
    new_state, log_vars, _ = step.lower(state, jb, rng).compile(
        FAST_COMPILE)(state, jb, rng)
    specs = dict(tp=jax_tp.tree_specs(jstate.params),
                 zero=jax_zero.zero_specs(jstate, mesh,
                                          rules if tp > 1 else None,
                                          level=zero or 1))
    return jax.device_get((new_state, log_vars)), audit, specs


def _paths(tree, keep):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {'/' + '/'.join(str(getattr(k, 'key', getattr(k, 'name', k)))
                           for k in path)
            for path, spec in flat if keep(spec)}


def _pfgst_task(level, seed):
    """PFGST (``print_grad_magnitude``) on the narrow ResNet, from the
    golden traces' config, its teacher a perturbed copy."""
    cfg = dict(uda=dict(pfgst_uda_cfg('all'), print_grad_magnitude=True),
               model=cnn_cfg(), runner=dict(max_iters=100))
    cfg['model']['decode_head']['dropout_ratio'] = 0.1
    algo = build_algorithm(copy.deepcopy(cfg), device='cpu')
    state = algo.init_state(torch.Generator().manual_seed(seed),
                            build_optimizer(SGD))
    g = torch.Generator().manual_seed(seed + 1)
    teacher = {k: v + 0.05 * torch.randn(v.shape, generator=g)
               if v.is_floating_point() else v
               for k, v in state.student.state_dict().items()}
    rs = np.random.RandomState(seed)
    batch = {'img': nchw(_images(rs)), 'gt_semantic_seg':
             torch.from_numpy(_labels(rs)), 'target_img': nchw(_images(rs)),
             'target_img_strong_aug': nchw(_images(rs))}
    return dict(kind='gspmd_step', cfg=cfg,
                opt=SGD, step=3,
                state={'student': state.student.state_dict(),
                       'teacher': teacher},
                batch=batch, zero=level, tp=1, gen_seeds=[11, 12],
                single=True)


def _loop_root(directory):
    root = str(directory / 'data')
    make_synthetic_data_torch.main(['-o', osp.join(root, 'pots'), '--size',
                                    '128', '--num-train', '4',
                                    '--num-val', '0'])
    make_synthetic_data_torch.main(['-o', osp.join(root, 'vaih'), '--size',
                                    '128', '--num-train', '4',
                                    '--num-val', '2', '--seed', '1'])
    pack_dataset_torch.main([root, '--recursive'])
    cfg = tiny_config(root)
    # one loader thread: the pipelines' draws in a fixed order
    cfg.merge_from_dict({'checkpoint_config.interval': LOOP_ITERS,
                         'evaluation.interval': LOOP_ITERS,
                         'data.workers_per_gpu': 1})
    path = str(directory / 'tiny.py')
    cfg.dump(path)
    return path


@pytest.fixture(scope='module')
def gspmd(tmp_path_factory):
    """Every rank's results and the JAX references, computed once."""
    def compute():
        directory = shared_dir(tmp_path_factory) / 'gspmd_ranks'
        directory.mkdir(exist_ok=True)
        jmodel, tx, jstate, student = _vit_case()
        batch = _batch(3)
        base = dict(kind='gspmd_step', cfg=dict(model=_vit()), opt=SGD,
                    step=0, state={'student': student}, batch=batch,
                    gen_seeds=[5], single=True, specs=True)
        drop = dict(base, cfg=dict(model=_vit(0.1)), gen_seeds=[5, 6],
                    specs=False)
        jobs = {2: {}, 4: {}}
        for name, tp, zero, world in MODES:
            jobs[world][name] = dict(base, tp=tp, zero=zero)
            jobs[world][name + '_dropout'] = dict(drop, tp=tp, zero=zero)
        d2 = directory / 'two'
        d2.mkdir(exist_ok=True)
        jobs[2]['zero3_resume'] = dict(base, tp=1, zero=3, resume=True,
                                       gen_seeds=[5, 6], specs=False,
                                       dir=str(d2 / 'ckpt'))
        jobs[2]['pfgst_zero1'] = _pfgst_task(1, 21)
        jobs[2]['pfgst_zero3'] = _pfgst_task(3, 22)
        config = _loop_root(directory)
        jobs[2]['loop'] = dict(kind='gspmd_loop', config=config,
                               iters=LOOP_ITERS, parallel=dict(tp=2),
                               work_dir=str(d2 / 'work'))
        d4 = directory / 'four'
        d4.mkdir(exist_ok=True)
        # the four ranks' loop is held to itself: no single-process run
        jobs[4]['loop'] = dict(kind='gspmd_loop', config=config,
                               iters=LOOP_ITERS, parallel=dict(tp=2, zero=3),
                               work_dir=str(d4 / 'work'), single=False)
        procs = {w: start_ranks(jobs[w], str(directory / n), w)
                 for w, n in ((2, 'two'), (4, 'four'))}
        try:
            with two_pass_batch_variance():
                refs = {name: _jax_mode(jmodel, tx, jstate, batch, tp, zero)
                        for name, tp, zero, _ in MODES}
        finally:
            ranks = {w: join_ranks(p, str(directory / ('two' if w == 2
                                                       else 'four')))
                     for w, p in procs.items()}
        loop_ckpt = osp.join(jobs[4]['loop']['work_dir'],
                             f'iter_{LOOP_ITERS}.pth')
        loaded = init_segmentor(Config.fromfile(config), loop_ckpt,
                                device='cpu').state_dict()
        return dict(ranks=ranks, refs=refs, jstate=jax.device_get(jstate),
                    loaded={k: v.shape for k, v in loaded.items()})

    return shared_by_workers(tmp_path_factory, 'gspmd', compute)


def _world(name):
    return next((w for n, _, _, w in MODES
                 if name in (n, n + '_dropout')), 2)


def _ranks(gspmd, name):
    return [r[name] for r in gspmd['ranks'][_world(name)]]


def _close(a, b, what):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), err_msg=what,
                               **TOL)


# ------------------------------- the steps ---------------------------------
@pytest.mark.parametrize('mode', [m[0] for m in MODES])
def test_step_matches_the_jax_mode(gspmd, mode):
    """One step of each mode against the JAX mode on virtual devices:
    log vars, the gathered post-step parameters and BN statistics (the
    running variance unbiased over the global count of 64 values)."""
    (new_state, log_vars), _, _ = gspmd['refs'][mode]
    got = _ranks(gspmd, mode)[0]
    assert sorted(got['logs'][0]) == sorted(log_vars)
    for k, v in log_vars.items():
        _close(got['logs'][0][k], float(v), k)
    student = got['modules']['student']
    port = build_segmentor(_vit())
    before = jax_variables_to_state_dict(
        {'params': gspmd['jstate'].params,
         'batch_stats': gspmd['jstate'].batch_stats},
        port.state_dict(), **key_families(port))
    after = jax_variables_to_state_dict(
        {'params': new_state.params, 'batch_stats': new_state.batch_stats},
        port.state_dict(), **key_families(port))
    names = {n for n, _ in port.named_parameters()}
    assert len(names) == 33
    for k in names:
        _close(student[k], after[k], f'post-step {k}')
    bn = 'decode_head.convs.0.bn'
    _close(student[f'{bn}.running_mean'], after[f'{bn}.running_mean'],
           'running mean')
    c = 64 / 63
    _close(student[f'{bn}.running_var'],
           c * after[f'{bn}.running_var'] -
           (c - 1) * 0.9 * before[f'{bn}.running_var'], 'running var')


@pytest.mark.parametrize('case', [m[0] for m in MODES] +
                         [m[0] + '_dropout' for m in MODES] +
                         ['pfgst_zero1', 'pfgst_zero3'])
def test_steps_match_the_single_process_step(gspmd, case):
    """The mode's steps against the port's single-process steps over the
    global batch (with the head's dropout on, two steps; PFGST with the
    whole batch's ``grad_mag``): every rank's log vars, the whole
    modules."""
    logs, modules = _ranks(gspmd, case)[0]['single']
    if case.startswith('pfgst'):
        assert 'grad_mag' in logs[0]
    for rank in _ranks(gspmd, case):
        for got, want in zip(rank['logs'], logs, strict=True):
            assert sorted(got) == sorted(want)
            for k in want:
                _close(got[k], want[k], f'{case} {k}')
        for name, sd in modules.items():
            for k, v in sd.items():
                _close(rank['modules'][name][k], v, f'{case} {name}.{k}')


def test_ranks_agree_and_model_ranks_hold_the_same_replicated_leaves(gspmd):
    """After the steps every rank reports the same log vars and holds the
    same whole modules; the model ranks of a data index hold the
    replicated leaves bit for bit, the tensor-parallel ones as their own
    shards (the ViT's qkv, proj, fc1 and fc2: 2 layers x 6)."""
    for name, tp, _, world in MODES:
        ranks = _ranks(gspmd, name + '_dropout')
        for r in ranks[1:]:
            assert r['logs'] == ranks[0]['logs']
            for k, v in ranks[0]['modules']['student'].items():
                assert torch.equal(r['modules']['student'][k], v), (name, k)
        if tp > 1:
            sharded = set(ranks[0]['tp_keys'])
            assert len(sharded) == 12
            for a, b in zip(ranks[::2], ranks[1::2]):
                for k, v in a['local'].items():
                    if k in sharded:
                        assert not torch.equal(v, b['local'][k]), k
                    else:
                        assert torch.equal(v, b['local'][k]), k


# ------------------------------ the layouts --------------------------------
def test_tp_sharded_leaves_are_the_jax_set(gspmd):
    """``tree_specs``: the leaves the rules shard, by JAX path, are the
    JAX function's."""
    _, _, specs = gspmd['refs']['tp2']
    want = _paths(specs['tp'], lambda s: s != P())
    got = {k for k, v in _ranks(gspmd, 'tp2')[0]['tp_specs'].items() if v}
    assert got == want and len(want) == 12


@pytest.mark.parametrize('mode', ['zero1', 'zero3', 'tp2_zero1'])
def test_zero_sharded_leaves_are_the_jax_set(gspmd, mode):
    """``zero_specs``: the moments (and at level 3 the parameters) sharded
    over the data ranks, by JAX path, are the JAX function's."""
    _, _, specs = gspmd['refs'][mode]
    jspec = specs['zero']
    port = _ranks(gspmd, mode)[0]['zero_specs']

    def sharded(tree):
        return _paths(tree, lambda s: 'data' in tuple(s))

    # the momentum's mirror of the parameters, by parameter path
    flat = jax.tree_util.tree_flatten_with_path(
        jspec.opt_state, is_leaf=lambda x: isinstance(x, P))[0]
    moments = set()
    for path, spec in flat:
        names = [str(getattr(k, 'key', getattr(k, 'name', k))) for k in path]
        if 'trace' in names and 'data' in tuple(spec):
            moments.add('/' + '/'.join(names[names.index('trace') + 1:]))
    assert moments
    assert {k for k, d in port['opt_state'].items() if d is not None} == \
        moments
    level3 = {k for k, d in port['params'].items() if d is not None}
    assert level3 == (sharded(jspec.params) if mode == 'zero3' else set())


@pytest.mark.parametrize('mode', ['zero1', 'zero3', 'tp2_zero1'])
def test_stored_bytes_sum_to_the_jax_audit(gspmd, mode):
    """The moments' bytes the ranks store, and would store whole, sum to
    JAX's ``tree_bytes`` of the sharded state; at level 3 the parameters'
    too."""
    _, audit, _ = gspmd['refs'][mode]
    ranks = _ranks(gspmd, mode)
    stored = sum(r['opt_bytes'][0] for r in ranks)
    whole = sum(r['opt_bytes'][1] for r in ranks)
    assert (stored, whole) == audit['opt']
    assert stored < 0.6 * whole
    if mode == 'zero3':
        p = [r['tree_bytes']['student'] for r in ranks]
        assert (sum(s for s, _ in p), sum(w for _, w in p)) == \
            audit['params']


# ------------------------------ checkpoints --------------------------------
def test_zero3_checkpoint_is_whole_and_resumes(gspmd):
    """The ZeRO-3 checkpoint after step 1 holds the whole student and
    SGD moments (the single-process keys and shapes); the single-process
    port loaded from it, and a fresh ZeRO-3 state resumed from it, step on
    as the sharded run did."""
    ranks = _ranks(gspmd, 'zero3_resume')
    single = ranks[0]['resumed_single']
    whole = ranks[0]['single'][1]['student']
    assert single['ckpt_keys'] == sorted(whole)
    moments = [st['momentum_buffer'] for st in
               single['opt_state']['state'].values()]
    assert sorted(m.shape for m in moments) == sorted(
        v.shape for k, v in whole.items() if not k.endswith(
            ('running_mean', 'running_var', 'num_batches_tracked')))
    cont = ranks[0]
    for k, v in cont['logs'][1].items():
        _close(single['log_vars'][k], v, k)
        for r in ranks:
            _close(r['resumed']['log_vars'][k], v, k)
    for k, v in cont['modules']['student'].items():
        _close(single['student'][k], v, k)
        for r in ranks:
            assert torch.equal(r['resumed']['modules']['student'][k], v), k


# -------------------------------- the loop ---------------------------------
def test_train_loop_at_tp2_is_the_single_process_loop(gspmd):
    """``train_segmentor`` with ``parallel.tp=2`` on two ranks (one data
    index: both take the whole batch) logs, on every rank, what the
    single-process loop logs, and writes its checkpoint."""
    ranks = [r['loop'] for r in gspmd['ranks'][2]]
    want = ranks[0]['single']
    for r in ranks:
        assert len(r['history']) == LOOP_ITERS
        for got, ref in zip(r['history'], want['history'], strict=True):
            for k, v in ref['log_vars'].items():
                _close(got['log_vars'][k], v, k)
    for k, v in want['ckpt'].items():
        _close(ranks[0]['ckpt'][k], v, k)


def test_train_loop_at_tp2_zero3_on_four_ranks(gspmd):
    """At tp 2 x ZeRO-3 on four ranks every rank logs the same finite log
    vars, and the whole checkpoint loads into the single-process port."""
    ranks = [r['loop'] for r in gspmd['ranks'][4]]
    logs = [[h['log_vars'] for h in r['history']] for r in ranks]
    assert len(logs[0]) == LOOP_ITERS
    assert all(lv == logs[0] for lv in logs)
    assert all(np.isfinite(list(v.values())).all() for v in logs[0])
    ckpt = ranks[0]['ckpt']
    assert gspmd['loaded']
    for k, shape in gspmd['loaded'].items():
        assert ckpt[f'model.{k}'].shape == shape, k


# ------------------------ the rules, refusals, CLI -------------------------
def test_zero_dim_is_the_jax_rule():
    """The first largest dimension that divides by the data ranks, a
    tensor-parallel one kept out; none for a scalar, one rank or an
    indivisible leaf."""
    assert _zero_dim((3, 8, 8), 2) == 1
    assert _zero_dim((16, 8), 2, tp_dim=0) == 1
    assert _zero_dim((16,), 2, tp_dim=0) is None
    assert _zero_dim((3, 5), 2) is None
    assert _zero_dim((), 2) is None
    assert _zero_dim((8, 8), 1) is None


@pytest.mark.parametrize('option', ['sp', 'spw'])
def test_spatial_training_raises_naming_its_item(option):
    """``parallel.sp`` / ``spw`` train under a launcher
    (``tests/test_torch_spatial_train.py``); in one process, without one,
    they raise the JAX divisibility assert, naming the option's degree."""
    cfg = Config(dict(data=dict(), parallel={option: 2}))
    _refuse_waiting(cfg)
    want = 'sp=2x spw=1' if option == 'sp' else 'sp=1x spw=2'
    with pytest.raises(AssertionError,
                       match=f'1 devices not divisible by parallel.{want}'):
        _gspmd_layout(cfg, None)


@pytest.mark.parametrize('option', BLOCK_PARALLEL)
def test_pp_and_ep_are_no_loop_modes(option):
    """``parallel.pp`` / ``ep`` raise, naming the building blocks; ``tp``
    and ``zero`` pass."""
    with pytest.raises(NotImplementedError,
                       match=f"'{option}'.*gpipe_apply.*moe_apply"):
        _refuse_waiting(Config(dict(data=dict(), parallel={option: 2})))
    _refuse_waiting(Config(dict(data=dict(), parallel=dict(tp=2, zero=3))))


def test_zero_refuses_a_dict_of_optimizers():
    """A dict-of-optimizers config (``DomainAdaptorAdv``) does not compose
    with ZeRO or tensor parallelism (``train.py:468-470``)."""
    from pfst_tpu_torch.parallel import zero
    state = type('S', (), {})()
    state.optimizer = {'generator': None}
    with pytest.raises(ValueError, match='dict-of-optimizers'):
        zero.attach(state, None, 1)


def test_train_cli_tp_and_zero_reach_cfg_parallel(tmp_path):
    """``--tp N`` and ``--zero [1|3]`` land in ``cfg.parallel``, merged
    over its other keys (``tests/test_tp.py:228``)."""
    cfg_file = tmp_path / 'c.py'
    cfg_file.write_text('parallel = dict(other=1)\nmodel = dict()\n')
    args = train_torch.parse_args([str(cfg_file), '--tp', '2', '--zero'])
    cfg = Config.fromfile(args.config)
    cfg.merge_from_dict(train_torch.parallel_options(args))
    assert dict(cfg.parallel) == dict(other=1, tp=2, zero=1)
    args = train_torch.parse_args([str(cfg_file), '--zero', '3'])
    assert train_torch.parallel_options(args) == {'parallel.zero': 3}
    assert train_torch.parallel_options(
        train_torch.parse_args([str(cfg_file)])) == {}
