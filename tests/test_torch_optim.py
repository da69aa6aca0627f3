"""The port's optimizer options against optax through the JAX package's
``build_optimizer`` / ``build_optimizers``, on the CPU: the dict of
optimizers, ``paramwise_cfg`` (custom keys' ``lr_mult`` / ``decay_mult``,
the longest key first), layer decay and its two mmcv constructor names,
``cumulative_iters`` (optax ``MultiSteps``) and ``skip_nonfinite`` (optax
``apply_if_finite``); the per-parameter multipliers on a ResNet's and a
ViT's converted names; and the checkpoint of everything the adversarial
adaptor's state and these options carry, resumed bitwise.

Tolerance: parameters atol 2.4e-7, two fp32 ulps at their magnitudes
(below 1; AdamW's division rounds a last bit otherwise than optax's in a
few elements), the LR rtol 1e-6.
"""
import copy

import numpy as np
import pytest
import torch

# torch's OpenMP pool must not run beside XLA-CPU in one process
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from conftest import tiny_model_cfg  # noqa: E402
from test_torch_vit import tiny_vit_cfg  # noqa: E402
from torch_parity import jax_variables, load_port, run_jit  # noqa: E402

from pfst_tpu.core import optimizers as jax_opt  # noqa: E402
from pfst_tpu.models import build_segmentor as jax_segmentor  # noqa: E402
from pfst_tpu_torch.apis import build_algorithm  # noqa: E402
from pfst_tpu_torch.core import (build_optimizer, build_optimizers,  # noqa: E402
                                 jax_variables_to_state_dict,
                                 load_checkpoint, load_weights_into_state,
                                 restore_state, save_checkpoint)
from pfst_tpu_torch.models import build_segmentor  # noqa: E402

ATOL = 2.4e-7
LR_CFG = dict(policy='poly', warmup='linear', warmup_iters=4,
              warmup_ratio=0.1, power=1.0)
# flat names, so that the JAX tree's '/'-joined paths and the port's names
# are the same strings
NAMES = ('backbone_stem_conv', 'backbone_layer2_block1_conv2',
         'backbone_blocks3_norm', 'backbone_other', 'decode_head_conv',
         'decode_head_norm', 'pos_embed')
CUSTOM = dict(custom_keys={'backbone': dict(lr_mult=0.1),
                           'norm': dict(decay_mult=0.0),
                           'head': dict(lr_mult=10.0),
                           'decode_head_norm': dict(lr_mult=3.0,
                                                    decay_mult=0.5)})
OPTIMIZERS = {
    'sgd': dict(type='SGD', lr=0.01, momentum=0.9, weight_decay=0.05),
    'adamw': dict(type='AdamW', lr=1e-3, betas=(0.9, 0.999),
                  weight_decay=0.05)}


def _toy(seed=0):
    rs = np.random.RandomState(seed)
    return {n: (rs.randn(3, 4) * 0.3).astype(np.float32) for n in NAMES}


class _Run:
    """The same updates on both sides: optax on a flat tree, the port on
    tensors named as its keys."""

    def __init__(self, opt_cfg, max_iters=20, grad_clip=None, **options):
        params = _toy()
        self.tx = jax_opt.build_optimizer(opt_cfg, LR_CFG, max_iters,
                                          grad_clip, **options)
        self.jparams = jax.tree.map(jnp.asarray, params)
        self.opt_state = self.tx.init(self.jparams)
        self.update = jax.jit(self.tx.update)
        self.port = {k: torch.from_numpy(v.copy()).requires_grad_()
                     for k, v in params.items()}
        self.opt = build_optimizer(opt_cfg, LR_CFG, max_iters, grad_clip,
                                   **options)(list(self.port.items()))

    def step(self, grads):
        updates, self.opt_state = self.update(
            jax.tree.map(jnp.asarray, grads), self.opt_state, self.jparams)
        self.jparams = optax.apply_updates(self.jparams, updates)
        self.opt.zero_grad()
        for k, p in self.port.items():
            p.grad = torch.from_numpy(grads[k].copy())
        return self.opt.step()

    def check(self, what=''):
        for k, p in self.port.items():
            np.testing.assert_allclose(p.detach().numpy(), self.jparams[k],
                                       atol=ATOL, rtol=0,
                                       err_msg=f'{what} {k}')


def _grads(rs, scale=1.0):
    return {n: (rs.randn(3, 4) * scale).astype(np.float32) for n in NAMES}


@pytest.mark.parametrize('opt', sorted(OPTIMIZERS))
@pytest.mark.parametrize('mode', ['custom_keys', 'layer_decay',
                                  'LayerDecayOptimizerConstructor'])
def test_paramwise_and_layer_decay_match_optax(opt, mode):
    """Five updates under a moving schedule: ``custom_keys`` (the longest
    matching key wins: ``decode_head_norm`` over ``head`` and ``norm``),
    ``LearningRateDecayOptimizerConstructor`` with ``num_layers`` /
    ``decay_rate``, and the deprecated ``LayerDecayOptimizerConstructor``
    spelling with ``layer_decay_rate``."""
    cfg = dict(OPTIMIZERS[opt])
    if mode == 'custom_keys':
        cfg['paramwise_cfg'] = copy.deepcopy(CUSTOM)
    elif mode == 'layer_decay':
        cfg.update(constructor='LearningRateDecayOptimizerConstructor',
                   paramwise_cfg=dict(num_layers=4, decay_rate=0.7))
    else:
        cfg.update(constructor=mode,
                   paramwise_cfg=dict(num_layers=4, layer_decay_rate=0.7))
    run = _Run(cfg)
    lrs = {g['lr'] for g in run.opt.optimizer.param_groups}
    assert len(lrs) >= 3, lrs
    rs = np.random.RandomState(1)
    for step in range(5):
        run.step(_grads(rs))
        run.check(f'step {step}')


def test_build_optimizers_gives_a_dict_of_factories():
    """A dict of configs (the reference's ``generator`` /
    ``discriminator`` pair) gives a factory each, each optax's."""
    cfg = dict(generator=OPTIMIZERS['sgd'], discriminator=dict(
        OPTIMIZERS['adamw'], lr=5e-3))
    port = build_optimizers(cfg, LR_CFG, 20)
    ref = jax_opt.build_optimizers(cfg, LR_CFG, 20)
    assert sorted(port) == sorted(ref) == ['discriminator', 'generator']
    assert callable(build_optimizers(OPTIMIZERS['sgd']))
    rs = np.random.RandomState(2)
    for name in cfg:
        params = _toy(3)
        tensors = [torch.from_numpy(v.copy()).requires_grad_()
                   for v in params.values()]
        opt = port[name](tensors)
        jparams = jax.tree.map(jnp.asarray, params)
        state = ref[name].init(jparams)
        for _ in range(3):
            grads = _grads(rs)
            updates, state = ref[name].update(
                jax.tree.map(jnp.asarray, grads), state, jparams)
            jparams = optax.apply_updates(jparams, updates)
            for t, g in zip(tensors, grads.values()):
                t.grad = torch.from_numpy(g)
            opt.step()
        for t, k in zip(tensors, params):
            np.testing.assert_allclose(t.detach().numpy(), jparams[k],
                                       atol=ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize('opt', sorted(OPTIMIZERS))
def test_cumulative_iters_matches_multisteps(opt):
    """k = 3 over 8 iterations with a clip that the mean's norm stays
    under and a sum's would not: the parameters move on the 3rd and 6th
    only, by the mean gradient, and the schedule of update s is read at
    ``3 s + 2``; the 7th and 8th accumulate."""
    run = _Run(OPTIMIZERS[opt], grad_clip=dict(max_norm=3.0),
               cumulative_iters=3)
    schedule = jax_opt.build_lr_schedule(LR_CFG, OPTIMIZERS[opt]['lr'], 20)
    rs = np.random.RandomState(4)
    for it in range(8):
        before = {k: p.detach().clone() for k, p in run.port.items()}
        lr = run.opt.lr
        applied = run.step(_grads(rs, scale=0.3))
        run.check(f'iteration {it}')
        assert applied == (it % 3 == 2), it
        moved = any(not torch.equal(before[k], p)
                    for k, p in run.port.items())
        assert moved == applied, it
        if applied:
            np.testing.assert_allclose(lr, float(schedule(it)), rtol=1e-6)
    assert run.opt.mini_step == int(run.opt_state.mini_step) == 2


@pytest.mark.parametrize('k', [1, 2])
def test_skip_nonfinite_matches_apply_if_finite(k):
    """N = 2 (with ``cumulative_iters`` k): a NaN or Inf step leaves the
    parameters, moments and accumulator as they were; the third
    non-finite step in a row goes through, as optax's does."""
    run = _Run(OPTIMIZERS['adamw'], skip_nonfinite=2, cumulative_iters=k)
    rs = np.random.RandomState(5)
    pattern = ['ok', 'nan', 'ok', 'ok', 'inf', 'nan', 'ok', 'ok', 'nan',
               'nan', 'nan']
    for it, kind in enumerate(pattern):
        grads = _grads(rs)
        if kind != 'ok':
            grads['backbone_other'][1, 2] = np.nan if kind == 'nan' \
                else np.inf
        applied = run.step(grads)
        run.check(f'iteration {it} ({kind})')
        state = run.opt_state
        assert run.opt.notfinite_count == int(state.notfinite_count), it
        assert run.opt.total_notfinite == int(state.total_notfinite), it
        if kind != 'ok' and it < len(pattern) - 1:
            assert not applied, it
    assert run.opt.total_notfinite == 6
    # the third in a row went through: NaN in the parameters on both sides
    assert np.isnan(run.port['backbone_other'].detach().numpy()).any()


def _vit():
    return tiny_vit_cfg(), (1, 32, 32, 3)


def _resnet():
    return tiny_model_cfg(), (1, 64, 64, 3)


@pytest.mark.parametrize('mode', ['custom_keys', 'layer_decay'])
@pytest.mark.parametrize('model', ['resnet', 'vit'])
def test_multipliers_match_jax_on_converted_names(model, mode):
    """One SGD update with weight decay of a model's whole parameter tree,
    every gradient 1, on both sides: each parameter moves by -lr * lr_mult
    * (1 + wd * decay_mult * p), so the moved weights hold every
    parameter's multipliers. The port reads them from each parameter's JAX
    path (``core.optimizers.param_paths``), which reproduces the JAX
    file's labels, its quirks too (``conv1`` anywhere is layer 0; the JAX
    name of the auxiliary head, ``aux_heads_0``, holds no ``head``)."""
    cfg, shape = _vit() if model == 'vit' else _resnet()
    jmodel = jax_segmentor(copy.deepcopy(cfg))
    variables = jax_variables(jmodel, shape)
    port = load_port(build_segmentor(copy.deepcopy(cfg)), variables)
    opt_cfg = dict(type='SGD', lr=0.1, weight_decay=0.5)
    if mode == 'custom_keys':
        opt_cfg['paramwise_cfg'] = dict(custom_keys={
            'backbone': dict(lr_mult=0.1), 'norm': dict(decay_mult=0.0),
            'head': dict(lr_mult=10.0), 'pos_embed': dict(decay_mult=0.0),
            'layer4': dict(lr_mult=0.5)})
    else:
        opt_cfg.update(constructor='LearningRateDecayOptimizerConstructor',
                       paramwise_cfg=dict(num_layers=4, decay_rate=0.5))
    tx = jax_opt.build_optimizer(opt_cfg)
    params = variables['params']
    updates, _ = run_jit(tx.update, jax.tree.map(jnp.ones_like, params),
                         tx.init(params), params)
    want = jax_variables_to_state_dict(
        {'params': optax.apply_updates(params, updates),
         'batch_stats': variables['batch_stats']}, port.state_dict())
    opt = build_optimizer(opt_cfg)(port)
    for p in port.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    got = port.state_dict()
    for name, _ in port.named_parameters():
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   atol=ATOL, rtol=0, err_msg=name)
    assert len({g['lr'] for g in opt.optimizer.param_groups}) >= 3


def test_checkpoint_resumes_adv_state_bitwise(tmp_path):
    """DomainAdaptorAdv under ``cumulative_iters`` 2 and ``skip_nonfinite``
    1 (both optimizers) saves its discriminator, both optimizers'
    moments, schedules, accumulators and counters; a state restored from
    the file takes the next step bitwise as the saved one does.
    ``load_from`` warm-starts the segmentor alone."""
    seg = tiny_model_cfg()
    seg.pop('type')
    model = dict(seg, type='DomainAdaptorAdv', discriminator=dict(
        type='FCDiscriminator', num_in_channels=6, ndf=4),
        gen_losses=[dict(type='AdvLoss', net_type='gen',
                         weights={'loss_gen': 0.5})],
        disc_losses=[dict(type='AdvLoss', net_type='disc')])
    model['decode_head']['dropout_ratio'] = 0.0
    model['auxiliary_head']['dropout_ratio'] = 0.0
    opt_cfg = dict(generator=OPTIMIZERS['adamw'],
                   discriminator=dict(OPTIMIZERS['sgd'], lr=0.05))
    algo = build_algorithm(dict(model=model), device='cpu')

    def fresh(seed):
        return algo.init_state(torch.Generator().manual_seed(seed),
                               build_optimizers(opt_cfg, LR_CFG, 20,
                                                cumulative_iters=2,
                                                skip_nonfinite=1))
    step = algo.make_train_step([0.0] * 3, [1.0] * 3)
    rs = np.random.RandomState(6)

    def batch():
        return {'img': torch.from_numpy(rs.randn(2, 3, 32, 32).astype(
            np.float32)), 'gt_semantic_seg': torch.from_numpy(
            rs.randint(0, 6, (2, 32, 32))), 'target_img': torch.from_numpy(
            rs.randn(2, 3, 32, 32).astype(np.float32))}

    state = fresh(0)
    for i in range(3):
        state, _ = step(state, batch(), torch.Generator().manual_seed(i))
    state.optimizer.notfinite_count = 1
    assert state.optimizer.mini_step == 1 and state.optimizer.acc is not None
    path = save_checkpoint(str(tmp_path), 3, state)
    restored = restore_state(fresh(1), load_checkpoint(path))
    assert restored.step == 3
    assert restored.disc_optimizer.mini_step == 1
    assert restored.optimizer.notfinite_count == 1
    last = batch()
    outs = [step(s, dict(last), torch.Generator().manual_seed(9))
            for s in (state, restored)]
    (a, lv_a), (b, lv_b) = outs
    for k in lv_a:
        assert torch.equal(lv_a[k], lv_b[k]), k
    for module in ('student', 'discriminator'):
        sa, sb = (getattr(s, module).state_dict() for s in (a, b))
        for k in sa:
            assert torch.equal(sa[k], sb[k]), (module, k)
    ckpt = load_checkpoint(path)
    assert any(k.startswith('discriminator.') for k in ckpt['state_dict'])
    warm = load_weights_into_state(fresh(2), ckpt)
    for k, v in warm.student.state_dict().items():
        assert torch.equal(v, ckpt['state_dict'][f'model.{k}']), k
    assert not torch.equal(warm.discriminator.conv0.weight,
                           ckpt['state_dict']['discriminator.conv0.weight'])
    assert warm.optimizer.mini_step == 0
