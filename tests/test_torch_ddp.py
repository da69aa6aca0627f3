"""The port's data parallelism (``pfst_tpu_torch/parallel``) against the
JAX package's ``shard_map`` step, on the CPU.

Two gloo ranks of the port (``tests/torch_dist_worker.py``: processes
without JAX, one thread each, joined through a file store, every join and
collective limited to 120 s) each take half of a batch of 4 at 64², as
two of the conftest's virtual devices do under
``pfst_tpu.parallel.mesh._shard_map`` of the JAX algorithm's
``make_train_step(tx, mean, std, axis_name='data', jit=False)``, with the
replica index folded into the step's key as ``make_sharded_train_step``
folds it. The ranks start first and the JAX programs compile while they
run; the whole comparison is computed once a test run and shared across
xdist's workers.

* One SGD step of PFGST (``print_grad_magnitude`` on), of the supervised
  trainer and of ``DomainAdaptorAdv`` (both optimizers) from the same
  weights: log vars (``grad_mag`` each replica's norm, then averaged),
  post-step parameters and BN statistics. The PFGST step takes each
  rank's premix (the gradient-free half on its shard, held to JAX's in
  ``tests/test_torch_train.py``); the JAX step gets the same, sharded.
  After the step the two ranks' modules are bitwise equal, and one rank
  over a group of one steps bitwise as the single-process step.
* ``SyncBN`` over 2 ranks against flax's ``BatchNorm(axis_name='data')``
  under ``shard_map``: outputs, input gradients, running statistics; and
  against ``nn.BatchNorm2d`` over the whole batch.
* ``multi_gpu_test`` over 2 ranks, 5 images (the last share is short),
  equal to ``single_gpu_test``; ``sharded_slide_inference`` over 2 ranks
  against the port's single-process slide inference and the JAX
  function on 2 devices.
* The loader's ``dist`` shards, the rank in the step's generator, the
  backend resolution and the refusals of what waits (spatially sharded
  training, ROADMAP A14c-2).

The tiny model is ``tests/test_torch_uda_family.py``'s (the golden
traces' depth-18 ResNetV1c, FCN head, dropout 0). Tolerances are the
golden traces': log vars, parameters and BN statistics rtol 1e-3, atol
3e-5, the statistics once torch's n/(n-1) running-variance gap is taken
out with each replica's own n (ROADMAP C2); ``SyncBN`` atol 1e-5; the
slide inference atol 1e-5 (windows of two ranks add in another order).
"""
import copy
import os
import os.path as osp
import sys

import numpy as np
import pytest
import torch

# torch's OpenMP pool must not run beside XLA-CPU in one process
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import linen as fnn  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

from test_torch_loop import tiny_config  # noqa: E402
from test_uda_golden_trace import ALPHA, START_STEP  # noqa: E402
from test_uda_golden_trace import _uda_cfg as pfgst_uda_cfg  # noqa: E402
from torch_dist_worker import (MEAN, STD, ToyDataset, ToyLoader,  # noqa: E402
                               join_ranks, shard, start_ranks)
from torch_parity import (FAST_COMPILE, jax_variables, load_port,  # noqa: E402
                          nchw, nhwc, shared_by_workers, shared_dir,
                          two_pass_batch_variance)

from pfst_tpu.apis.train import SupervisedTrainer as JaxSupervised  # noqa: E402
from pfst_tpu.core import optimizers as jax_opt  # noqa: E402
from pfst_tpu.models import build_segmentor as jax_segmentor  # noqa: E402
from pfst_tpu.models import build_train_model as jax_train_model  # noqa: E402
from pfst_tpu.models.builder import SEGMENTORS as JAX_SEGMENTORS  # noqa: E402
from pfst_tpu.models.segmentors.domain_adaptor import \
    AdvTrainState as JaxAdvTrainState  # noqa: E402
from pfst_tpu.models.uda import uda_decorator as jax_uda  # noqa: E402
from pfst_tpu.parallel.mesh import _shard_map  # noqa: E402
from pfst_tpu.parallel.slide import \
    sharded_slide_inference as jax_slide  # noqa: E402
from pfst_tpu_torch.apis import (build_algorithm, init_segmentor,  # noqa: E402
                                 single_gpu_test)
from pfst_tpu_torch.apis.train import (_build_val,  # noqa: E402
                                       _gspmd_layout, _refuse_waiting,
                                       step_generator)
from pfst_tpu_torch.core import (build_optimizer, build_optimizers,  # noqa: E402
                                 jax_variables_to_state_dict,
                                 load_jax_train_state)
from pfst_tpu_torch.datasets import build_dataloader  # noqa: E402
from pfst_tpu_torch.models import build_segmentor, build_train_model  # noqa: E402
from pfst_tpu_torch.models.uda import UDATrainState  # noqa: E402
from pfst_tpu_torch.models.utils.layers import Norm  # noqa: E402
from pfst_tpu_torch.parallel import resolve_backend  # noqa: E402
from pfst_tpu_torch.utils import Config  # noqa: E402

sys.path.insert(0, osp.join(osp.dirname(__file__), '..', 'tools'))
import make_synthetic_data_torch  # noqa: E402
import pack_dataset_torch  # noqa: E402
from convert_torch_checkpoint import convert_state_dict  # noqa: E402

WORLD, B, HW, C = 2, 4, 64, 6
SGD = dict(type='SGD', lr=1e-2)
ADV_OPT = dict(generator=SGD, discriminator=dict(SGD, lr=1.0))
DISC = dict(type='FCDiscriminator', num_in_channels=C, ndf=8)
ADV = dict(
    type='DomainAdaptorAdv', discriminator=DISC,
    gen_losses=[dict(type='AdvLoss', loss_type='advent', net_type='gen',
                     weights={'loss_gen': 1.0})],
    disc_losses=[dict(type='AdvLoss', loss_type='advent', net_type='disc',
                      weights={'loss_disc_src': 0.5, 'loss_disc_trg': 0.5})])
SLIDE = dict(hw=(48, 40), crop=(32, 32), stride=(12, 12))
TOL = dict(rtol=1e-3, atol=3e-5)
LOOP_ITERS = 2


def _model_cfg():
    norm = dict(type='BN', requires_grad=True)
    return dict(
        type='EncoderDecoder',
        backbone=dict(type='ResNetV1c', depth=18, num_stages=4,
                      base_channels=8, stem_channels=8,
                      out_indices=(0, 1, 2, 3), dilations=(1, 1, 2, 4),
                      strides=(1, 2, 1, 1), norm_cfg=norm,
                      contract_dilation=True),
        decode_head=dict(type='FCNHead', in_channels=72, in_index=(0, 3),
                         input_transform='resize_concat', channels=16,
                         num_convs=1, concat_input=False, dropout_ratio=0.0,
                         num_classes=C, norm_cfg=norm, align_corners=False,
                         loss_decode=dict(type='CrossEntropyLoss',
                                          use_sigmoid=False,
                                          loss_weight=1.0)),
        train_cfg=dict(), test_cfg=dict(mode='whole'))


def _images(rs, b=B):
    shift = np.linspace(-2.0, 2.0, b).reshape(b, 1, 1, 1)
    return (rs.randn(b, HW, HW, 3) + shift).astype(np.float32)


def _labels(rs, b=B):
    """3x3 blocks of the classes, cut off the stride-8 grid; a band of
    255 across the top of each replica's first sample."""
    gt = np.empty((b, HW, HW), np.int32)
    for i in range(b):
        cuts = [0, *sorted(rs.choice(np.arange(16, HW - 16, 8) + 3, 2,
                                     replace=False)), HW]
        for r in range(3):
            for c in range(3):
                gt[i, cuts[r]:cuts[r + 1], cuts[c]:cuts[c + 1]] = \
                    rs.randint(C)
    gt[::b // WORLD, :8] = 255
    return gt


def _torch_batch(batch):
    return {k: torch.from_numpy(v) if v.ndim == 3 else nchw(v)
            for k, v in batch.items()}


def _mesh():
    return Mesh(np.asarray(jax.devices()[:WORLD]), ('data',))


def _sharded_jax_step(step_fn, state, batch, premix=None):
    """``step_fn`` (a JAX ``make_train_step(..., axis_name='data',
    jit=False)``) under ``shard_map`` on 2 devices, the key folded with
    the replica index (``mesh.py:98-100``): the new state and log vars."""
    def step(s, b, r, p):
        r = jax.random.fold_in(r, jax.lax.axis_index('data'))
        out = step_fn(s, b, r, premix=p) if p is not None else step_fn(s, b,
                                                                         r)
        return out[0], out[1]

    args = (state, batch, jax.random.PRNGKey(7), premix)
    fn = _shard_map(step, _mesh(), in_specs=(P(), P('data'), P(),
                                             P('data')),
                    out_specs=(P(), P()))
    out = jax.jit(fn).lower(*args).compile(FAST_COMPILE)(*args)
    return jax.device_get(out)


def _to_jax(premix):
    return {k: jnp.asarray(nhwc(v) if v.ndim == 4 else
                           v.numpy().astype(np.int32 if 'label' in k or
                                            'lbl' in k else np.float32))
            for k, v in premix.items()}


# ------------------------------- the cases ---------------------------------
def _pfgst_case():
    train_cfg = dict(uda=dict(pfgst_uda_cfg('all'), print_grad_magnitude=True),
                     model=_model_cfg(), runner=dict(max_iters=100))
    jalgo = jax_train_model(copy.deepcopy(train_cfg))
    student = jax_variables(jalgo.model, (1, HW, HW, 3), seed=0)
    rs = np.random.RandomState(1)
    teacher = jax.tree.map(
        lambda x: (x + 0.05 * rs.randn(*x.shape)).astype(np.float32),
        student)
    tx = jax_opt.build_optimizer(SGD)
    jstate = jax_uda.UDATrainState(
        params=student['params'], batch_stats=student['batch_stats'],
        ema_params=teacher['params'], ema_batch_stats=teacher['batch_stats'],
        opt_state=tx.init(student['params']),
        step=jnp.asarray(START_STEP, jnp.int32))
    rs = np.random.RandomState(5)
    batch = {'img': _images(rs), 'gt_semantic_seg': _labels(rs),
             'target_img': _images(rs), 'target_img_strong_aug': _images(rs)}
    algo = build_train_model(copy.deepcopy(train_cfg), device='cpu')
    state = load_jax_train_state(jstate, algo.init_state(
        torch.Generator().manual_seed(0), build_optimizer(SGD)))
    tbatch = _torch_batch(batch)
    premix = []
    for r in range(WORLD):
        updated = UDATrainState(student=state.student,
                                teacher=copy.deepcopy(state.teacher),
                                optimizer=None, step=state.step)
        draws = algo.sample_draws(torch.Generator().manual_seed(100 + r),
                                  B // WORLD)
        premix.append(algo.teacher_and_mix(
            algo.ema_update(updated, ALPHA),
            {k: shard(v, r, WORLD) for k, v in tbatch.items()}, draws, MEAN,
            STD))
    task = dict(kind='step', cfg=train_cfg, opt=SGD, step=START_STEP,
                state={'student': state.student.state_dict(),
                       'teacher': state.teacher.state_dict()},
                batch=tbatch, premix=premix, gen_seed=0, single=True)

    def reference():
        step_fn = jalgo.make_train_step(tx, MEAN, STD, axis_name='data',
                                        jit=False)
        jpremix = jax.tree.map(lambda *xs: jnp.concatenate(xs),
                               *[_to_jax(p) for p in premix])
        return _sharded_jax_step(step_fn, jstate, batch, jpremix), jstate

    return task, reference


def _supervised_case():
    cfg = dict(model=_model_cfg())
    jmodel = jax_segmentor(_model_cfg())
    variables = jax_variables(jmodel, (1, HW, HW, 3), seed=3)
    tx = jax_opt.build_optimizer(SGD)
    jstate = jax_uda.UDATrainState(
        params=variables['params'], batch_stats=variables['batch_stats'],
        ema_params={}, ema_batch_stats={},
        opt_state=tx.init(variables['params']),
        step=jnp.zeros((), jnp.int32))
    rs = np.random.RandomState(6)
    batch = {'img': _images(rs), 'gt_semantic_seg': _labels(rs)}
    algo = build_algorithm(copy.deepcopy(cfg), device='cpu')
    state = load_jax_train_state(jstate, algo.init_state(
        torch.Generator().manual_seed(0), build_optimizer(SGD)))
    task = dict(kind='step', cfg=cfg, opt=SGD, step=0,
                state={'student': state.student.state_dict()},
                batch=_torch_batch(batch), gen_seed=10)

    def reference():
        step_fn = JaxSupervised(jmodel).make_train_step(
            tx, MEAN, STD, axis_name='data', jit=False)
        return _sharded_jax_step(step_fn, jstate, batch), jstate

    return task, reference


def _adv_case():
    seg = _model_cfg()
    seg.pop('type')
    cfg = dict(model=dict(seg, **copy.deepcopy(ADV)))
    jadaptor = JAX_SEGMENTORS.build(copy.deepcopy(cfg['model']))
    tx = {k: jax_opt.build_optimizer(v) for k, v in ADV_OPT.items()}
    variables = jax_variables(jadaptor.model, (1, HW, HW, 3), seed=4)
    disc = jax_variables(jadaptor.discriminator, (1, 16, 16, C), seed=1)
    jstate = JaxAdvTrainState(
        params=variables['params'], batch_stats=variables['batch_stats'],
        disc_params=disc['params'],
        opt_state=tx['generator'].init(variables['params']),
        disc_opt_state=tx['discriminator'].init(disc['params']),
        step=jnp.zeros((), jnp.int32))
    rs = np.random.RandomState(7)
    batch = {'dom1_img': _images(rs), 'dom1_gt_semantic_seg': _labels(rs),
             'dom2_img': _images(rs), 'dom2_gt_semantic_seg': _labels(rs)}
    algo = build_algorithm(copy.deepcopy(cfg), device='cpu')
    state = load_jax_train_state(jstate, algo.init_state(
        torch.Generator().manual_seed(0), build_optimizers(ADV_OPT)))
    task = dict(kind='step', cfg=cfg, opt=ADV_OPT, step=0,
                state={'student': state.student.state_dict(),
                       'discriminator': state.discriminator.state_dict()},
                batch=_torch_batch(batch), gen_seed=20)

    def reference():
        step_fn = jadaptor.make_train_step(tx, MEAN, STD, axis_name='data',
                                           jit=False)
        return _sharded_jax_step(step_fn, jstate, batch), jstate

    return task, reference


def _sync_bn_case():
    rs = np.random.RandomState(8)
    x = (rs.randn(B, 5, 6, 7) * 2 + 1).astype(np.float32)
    g = rs.randn(*x.shape).astype(np.float32)
    bn = {'weight': rs.rand(5) + 0.5, 'bias': rs.randn(5),
          'running_mean': rs.randn(5), 'running_var': rs.rand(5) + 0.5}
    bn = {k: torch.tensor(v, dtype=torch.float32) for k, v in bn.items()}
    bn['num_batches_tracked'] = torch.tensor(3)
    task = dict(kind='sync_bn', x=torch.from_numpy(x), g=torch.from_numpy(g),
                bn=bn)

    def reference():
        module = fnn.BatchNorm(use_running_average=False, axis_name='data',
                               momentum=0.9, epsilon=1e-5)
        v = {'params': {'scale': bn['weight'].numpy(),
                        'bias': bn['bias'].numpy()},
             'batch_stats': {'mean': bn['running_mean'].numpy(),
                             'var': bn['running_var'].numpy()}}

        def local(v, x, g):
            y, vjp, upd = jax.vjp(lambda x: module.apply(
                v, x, mutable=['batch_stats']), x, has_aux=True)
            return y, vjp(g)[0], upd['batch_stats']

        fn = _shard_map(local, _mesh(), in_specs=(P(), P('data'),
                                                  P('data')),
                        out_specs=(P('data'), P('data'), P()))
        out = jax.jit(fn)(v, x.transpose(0, 2, 3, 1),
                          g.transpose(0, 2, 3, 1))
        return jax.device_get(out)

    return task, reference


def _eval_case():
    jmodel = jax_segmentor(_model_cfg())
    variables = jax_variables(jmodel, (1, HW, HW, 3), seed=9)
    port = load_port(build_segmentor(_model_cfg()), variables)
    dataset = dict(n=5, size=32, num_classes=C, seed=0)
    loader = ToyLoader(ToyDataset(**dataset))
    singles = {pre_eval: single_gpu_test(port, loader, pre_eval=pre_eval,
                                         progress=False)
               for pre_eval in (True, False)}
    h, w = SLIDE['hw']
    scene = np.random.RandomState(10).randn(h, w, 3).astype(np.float32)
    port.test_cfg = dict(mode='slide', crop_size=SLIDE['crop'],
                         stride=SLIDE['stride'])
    with torch.inference_mode():
        slide = port.slide_inference(nchw(scene[None]))[0][0]
    weights = port.state_dict()
    tasks = {
        'multi_gpu_test': dict(kind='multi_gpu_test', model=_model_cfg(),
                               weights=weights, dataset=dataset),
        'slide': dict(kind='slide', model=_model_cfg(), weights=weights,
                      scene=torch.from_numpy(scene.transpose(2, 0, 1)),
                      crop=SLIDE['crop'], stride=SLIDE['stride'])}

    def reference():
        return np.asarray(jax_slide(jmodel, variables, jnp.asarray(scene),
                                    SLIDE['crop'], SLIDE['stride'],
                                    mesh=_mesh()))

    return tasks, dict(singles=singles, slide=slide.numpy()), reference


def _loop_case(directory):
    """The tiny leaf config of ``tests/test_torch_loop.py`` on packs of 4
    + 4 training tiles and 3 validation tiles (128^2) under
    ``directory``, for ``train_segmentor`` on both ranks."""
    root = str(directory / 'data')
    make_synthetic_data_torch.main(['-o', osp.join(root, 'pots'), '--size',
                                    '128', '--num-train', '4',
                                    '--num-val', '0'])
    make_synthetic_data_torch.main(['-o', osp.join(root, 'vaih'), '--size',
                                    '128', '--num-train', '4',
                                    '--num-val', '3', '--seed', '1'])
    pack_dataset_torch.main([root, '--recursive'])
    cfg = tiny_config(root)
    cfg.merge_from_dict({'checkpoint_config.interval': LOOP_ITERS,
                         'evaluation.interval': LOOP_ITERS})
    path = str(directory / 'tiny.py')
    cfg.dump(path)
    return dict(kind='loop', config=path, iters=LOOP_ITERS,
                work_dir=str(directory / 'work'))


@pytest.fixture(scope='module')
def dp(tmp_path_factory):
    """Every rank's results and the JAX references, computed once."""
    def compute():
        directory = shared_dir(tmp_path_factory) / 'ddp_ranks'
        directory.mkdir(exist_ok=True)
        cases = {'pfgst': _pfgst_case(), 'supervised': _supervised_case(),
                 'adv': _adv_case(), 'sync_bn': _sync_bn_case()}
        eval_tasks, local, slide_ref = _eval_case()
        job = {name: task for name, (task, _) in cases.items()}
        job.update(eval_tasks, loop=_loop_case(directory))
        procs = start_ranks(job, str(directory), WORLD)
        try:
            # the JAX programs compile while the ranks run; flax's
            # statistics take the two-pass formula in all of them
            with two_pass_batch_variance():
                refs = {name: ref() for name, (_, ref) in cases.items()}
                refs['slide'] = slide_ref()
        finally:
            ranks = join_ranks(procs, str(directory))
        loop = job['loop']
        cfg = Config.fromfile(loop['config'])
        ckpt = osp.join(loop['work_dir'], f'iter_{LOOP_ITERS}.pth')
        local['loop_eval'] = single_gpu_test(
            init_segmentor(cfg, ckpt, device='cpu'),
            _build_val(cfg)['loader'], pre_eval=True, progress=False)
        local['loop_miou'] = _build_val(cfg)['dataset'].evaluate(
            local['loop_eval'], metric='mIoU')['mIoU']
        with open(osp.join(loop['work_dir'], 'train.log')) as f:
            local['loop_log'] = f.read()
        local['loop_files'] = sorted(os.listdir(loop['work_dir']))
        return dict(ranks=ranks, refs=refs, local=local,
                    inputs={k: v for k, v in job.items()
                            if k in ('sync_bn',)})

    return shared_by_workers(tmp_path_factory, 'ddp', compute)


# ------------------------------- the steps ---------------------------------
def _stats_want(template, jstate, new_bs, counts, passes):
    """The running statistics torch keeps where flax's are ``new_bs``:
    with c = n/(n-1) for a BN over n values a replica and momentum m,
    ``passes`` passes from v0 give torch's c * v_jax - (c - 1) (1 - m)^p
    v0, and the mean over replicas of equal n keeps that form."""
    before = jax_variables_to_state_dict(
        {'params': jstate.params, 'batch_stats': jstate.batch_stats},
        template)
    after = jax_variables_to_state_dict(
        {'params': jstate.params, 'batch_stats': new_bs}, template)
    want = {}
    for key in template:
        name, leaf = key.rsplit('.', 1)
        if leaf == 'running_mean':
            want[key] = after[key]
        elif leaf == 'running_var':
            c = counts[name] / (counts[name] - 1)
            want[key] = c * after[key] - (c - 1) * 0.9**passes * before[key]
    return want


def _assert_tree_close(got, want, what):
    flat = dict(jax.tree_util.tree_leaves_with_path(want))
    leaves = jax.tree_util.tree_leaves_with_path(got)
    assert len(leaves) == len(flat)
    for path, leaf in leaves:
        np.testing.assert_allclose(np.asarray(leaf), np.asarray(flat[path]),
                                   err_msg=f'{what} {path}', **TOL)


@pytest.mark.parametrize('case,passes', [('pfgst', 2), ('supervised', 1),
                                         ('adv', 2)])
def test_step_matches_jax_shard_map(dp, case, passes):
    """Two ranks' step against the JAX step on two devices: log vars
    (PFGST's ``grad_mag`` each replica's, averaged), post-step parameters
    (the discriminator's too) and BN statistics."""
    (new_state, log_vars), jstate = dp['refs'][case]
    got = dp['ranks'][0][case]
    assert got['step'] == int(new_state.step)
    assert sorted(got['log_vars']) == sorted(log_vars)
    if case == 'pfgst':
        assert {'grad_mag', 'loss_sim_pos'} <= set(log_vars)
    for k, v in log_vars.items():
        np.testing.assert_allclose(got['log_vars'][k], float(v),
                                   err_msg=k, **TOL)
    student = got['modules']['student']
    _assert_tree_close(convert_state_dict(student)[0], new_state.params,
                       'post-step student')
    if case == 'adv':
        disc = got['modules']['discriminator']
        _assert_tree_close({f'conv{i}': {
            'kernel': disc[f'conv{i}.weight'].numpy().transpose(2, 3, 1, 0),
            'bias': disc[f'conv{i}.bias'].numpy()}
            for i in range(len(new_state.disc_params))},
            new_state.disc_params, 'post-step disc')
    # each replica normalizes by its own shard (the stem's BN: 2 images at
    # stride 2)
    assert max(got['counts'].values()) == B // WORLD * (HW // 2)**2
    want = _stats_want(student, jstate, new_state.batch_stats,
                       got['counts'], passes)
    assert want
    for key, value in want.items():
        np.testing.assert_allclose(student[key].numpy(), value.numpy(),
                                   err_msg=f'BN stat {key}', **TOL)


@pytest.mark.parametrize('case', ['pfgst', 'supervised', 'adv'])
def test_replicas_stay_in_step(dp, case):
    """After the step both ranks hold the same modules, bit for bit, and
    report the same (averaged) log vars."""
    a, b = (r[case] for r in dp['ranks'])
    assert a['log_vars'] == b['log_vars']
    for name, sd in a['modules'].items():
        for k, v in sd.items():
            assert torch.equal(v, b['modules'][name][k]), (name, k)


def test_world_size_one_is_the_single_process_step(dp):
    """Rank 0's shard stepped over a group of one rank gives the step
    without a group, bitwise: parameters, buffers and log vars."""
    assert dp['ranks'][0]['pfgst']['single'] == dict(log_vars=True,
                                                     modules=True)


# -------------------------------- SyncBN -----------------------------------
def _sync_bn_ranks(dp):
    ranks = [r['sync_bn'] for r in dp['ranks']]
    return ranks, {k: torch.cat([r[k] for r in ranks]) for k in ('y', 'dx')}


def test_sync_bn_matches_flax_axis_name(dp):
    """Outputs, input gradients and running statistics against flax's
    cross-replica BN (two-pass variance); torch's running variance is the
    unbiased one over the global count."""
    ranks, full = _sync_bn_ranks(dp)
    y, dx, stats = dp['refs']['sync_bn']
    assert ranks[0]['kind'] == 'SyncBatchNorm'
    np.testing.assert_allclose(nhwc(full['y']), y, atol=1e-5, rtol=0)
    np.testing.assert_allclose(nhwc(full['dx']), dx, atol=1e-5, rtol=0)
    bn = dp['inputs']['sync_bn']['bn']
    n = dp['inputs']['sync_bn']['x'][:, 0].numel()
    c = n / (n - 1)
    for r in ranks:
        np.testing.assert_allclose(r['stats']['running_mean'].numpy(),
                                   stats['mean'], atol=1e-6)
        want = c * stats['var'] - (c - 1) * 0.9 * bn['running_var'].numpy()
        np.testing.assert_allclose(r['stats']['running_var'].numpy(), want,
                                   atol=1e-6)
        assert int(r['stats']['num_batches_tracked']) == 4


def test_sync_bn_is_batch_norm_over_the_global_batch(dp):
    """Over 2 ranks, ``SyncBN`` is ``nn.BatchNorm2d`` over the whole batch:
    outputs, input gradients, the ranks' weight and bias gradients summed,
    running statistics; its state dict has BatchNorm2d's keys."""
    ranks, full = _sync_bn_ranks(dp)
    inputs = dp['inputs']['sync_bn']
    bn = torch.nn.BatchNorm2d(inputs['x'].shape[1]).train()
    bn.load_state_dict(inputs['bn'])
    x = inputs['x'].clone().requires_grad_()
    y = bn(x)
    (y * inputs['g']).sum().backward()
    torch.testing.assert_close(full['y'], y.detach(), atol=1e-5, rtol=0)
    torch.testing.assert_close(full['dx'], x.grad, atol=1e-5, rtol=0)
    torch.testing.assert_close(ranks[0]['dw'] + ranks[1]['dw'],
                               bn.weight.grad, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(ranks[0]['db'] + ranks[1]['db'],
                               bn.bias.grad, atol=1e-4, rtol=1e-5)
    assert list(ranks[0]['stats']) == list(bn.state_dict())
    for k, v in bn.state_dict().items():
        torch.testing.assert_close(ranks[0]['stats'][k], v, atol=1e-6,
                                   rtol=1e-6)


def test_sync_bn_without_a_group_is_batch_norm():
    """Outside a data-parallel step (or at one rank) ``SyncBN`` is the
    plain layer, bitwise."""
    rs = np.random.RandomState(11)
    x = torch.from_numpy(rs.randn(2, 4, 5, 5).astype(np.float32))
    sync = Norm(4, dict(type='SyncBN')).train()
    plain = torch.nn.BatchNorm2d(4).train()
    plain.load_state_dict(sync.state_dict())
    assert torch.equal(sync(x), plain(x))
    for k, v in plain.state_dict().items():
        assert torch.equal(sync.state_dict()[k], v), k


# ------------------------------ evaluation ---------------------------------
@pytest.mark.parametrize('pre_eval', [True, False],
                         ids=['pre_eval', 'label_maps'])
def test_multi_gpu_test_equals_single_gpu_test(dp, pre_eval):
    """5 images over 2 ranks (3 and 2): every rank gets
    ``single_gpu_test``'s results in dataset order, exactly."""
    want = dp['local']['singles'][pre_eval]
    assert len(want) == 5
    for rank in dp['ranks']:
        got = rank['multi_gpu_test'][pre_eval]
        assert len(got) == len(want)
        for a, b in zip(got, want):
            for x, y in zip(a if pre_eval else [a], b if pre_eval else [b]):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_sharded_slide_inference_matches_single_process_and_jax(dp):
    """6 windows over 2 ranks against the port's single-process slide
    inference and the JAX function's on 2 devices."""
    want = dp['local']['slide']
    for rank in dp['ranks']:
        got = rank['slide'].numpy()
        assert got.shape == (C, *SLIDE['hw'])
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        np.testing.assert_allclose(got.transpose(1, 2, 0), dp['refs']['slide'],
                                   atol=1e-4, rtol=1e-4)


# --------------------------- loop and launchers ----------------------------
def test_loader_dist_shards_are_disjoint_and_cover_the_epoch(monkeypatch):
    """``dist``: rank r of the default group takes ``samples_per_gpu`` a
    batch from indices r::world of the seeded permutation; together the
    ranks' epochs cover the dataset once. Without it ``num_gpus``
    multiplies the batch."""
    from pfst_tpu_torch.parallel import mesh
    dataset = list(range(11))
    epochs = []
    for r in range(3):
        monkeypatch.setattr(mesh, 'get_dist_info', lambda r=r: (r, 3))
        loader = build_dataloader(dataset, 1, 1, dist=True, shuffle=True,
                                  seed=4, drop_last=False)
        assert (loader.rank, loader.world_size, loader.batch_size) == \
            (r, 3, 1)
        epochs.append(loader._epoch_indices(0))
    seen = np.concatenate(epochs)
    assert sorted(seen.tolist()) == dataset
    assert [len(e) for e in epochs] == [4, 4, 3]
    assert not np.array_equal(seen, np.arange(11))
    one = build_dataloader(dataset, 2, 1, num_gpus=3, shuffle=False)
    assert (one.batch_size, one.world_size) == (6, 1)


def test_step_generator_folds_in_the_rank():
    """Rank 0 draws what a single-process run draws; other ranks draw
    their own numbers; each is a function of (seed, iteration, rank)."""
    def draw(*key):
        return torch.rand(3, generator=step_generator(*key))
    assert torch.equal(draw(0, 5, 0), draw(0, 5))
    assert not torch.equal(draw(0, 5, 1), draw(0, 5))
    assert torch.equal(draw(0, 5, 1), draw(0, 5, 1))
    assert not torch.equal(draw(0, 5, 1), draw(0, 6, 1))


def test_backend_of_the_configs():
    """The shipped ``dist_params.backend='xla'`` is NCCL on the card and
    gloo on the CPU; an explicit gloo is kept; NCCL needs the card."""
    runtime = Config.fromfile(osp.join(osp.dirname(__file__), '..',
                                       'configs', '_base_',
                                       'default_runtime.py'))
    assert runtime.dist_params['backend'] == 'xla'
    assert resolve_backend('xla', 'cuda') == 'nccl'
    assert resolve_backend('xla', 'cpu') == 'gloo'
    assert resolve_backend('gloo', 'cuda') == 'gloo'
    with pytest.raises(ValueError, match='card'):
        resolve_backend('nccl', 'cpu')


@pytest.mark.parametrize('option', ['sp', 'spw'])
def test_other_parallelisms_still_raise_by_name(option):
    """Data parallelism runs, and ``tp``, ``zero``, ``sp`` and ``spw`` too
    since the sharded modes (``tests/test_torch_zero_tp.py``,
    ``tests/test_torch_spatial_train.py``); ``sp`` and ``spw`` compose with
    data parallelism only: ``sp`` with ``tp``, and ``spw`` with ``zero``,
    raise the JAX assert, naming them."""
    other = dict(tp=2) if option == 'sp' else dict(zero=1)
    cfg = Config(dict(data=dict(), parallel={option: 2, **other}))
    _refuse_waiting(cfg)
    with pytest.raises(AssertionError, match=r'parallel\.sp composes with '
                                             r'dp only \(not tp/zero\)'):
        _gspmd_layout(cfg, None)
    _refuse_waiting(Config(dict(data=dict(), parallel={option: 1})))


# ------------------------------- the loop ----------------------------------
def test_train_loop_over_two_ranks(dp):
    """``train_segmentor`` on two ranks of the tiny leaf config: each rank
    takes its own shard (disjoint indices an iteration), both log the same
    averaged log vars and end with the same student, bitwise; only rank
    0 wrote the work dir (one log, one checkpoint); the in-loop evaluation
    through ``multi_gpu_test`` (3 images, 2 and 1 a rank) gives every rank
    the metrics ``single_gpu_test`` gives on the checkpoint."""
    a, b = (r['loop'] for r in dp['ranks'])

    def kind(hist, k):
        return [h for h in hist if h['kind'] == k]

    for ba, bb in zip(kind(a['history'], 'batch'),
                      kind(b['history'], 'batch'), strict=True):
        assert ba['iter'] == bb['iter']
        assert not set(ba['indices']) & set(bb['indices'])
    logs = [[h['log_vars'] for h in kind(r['history'], 'log')]
            for r in (a, b)]
    assert len(logs[0]) == LOOP_ITERS and logs[0] == logs[1]
    assert all(np.isfinite(list(v.values())).all() for v in logs[0])
    for k, v in a['student'].items():
        assert torch.equal(v, b['student'][k]), k
    local = dp['local']
    assert local['loop_files'] == ['iter_2.pth', 'train.log']
    assert local['loop_log'].count('entering train loop') == 1
    (ea,), (eb,) = kind(a['history'], 'eval'), kind(b['history'], 'eval')
    assert ea['metrics'] == eb['metrics']
    assert ea['metrics']['mIoU'] == local['loop_miou']
