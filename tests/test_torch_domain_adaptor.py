"""The port's domain-adaptor family (DomainAdaptor, DomainAdaptorAdv with
its discriminator, DomainAdaptorV2, FMDAAdaptor and FMDAAdaptorV2), its
losses, the new aux losses under PFGST, the dataset wrappers and the
source-only config against the JAX package's, on the CPU.

The model is the FCN-head golden model of ``tests/test_torch_uda_family.py``
(``_model_cfg``) with an FCN auxiliary head on level 2, 6 classes, at the
golden traces' batch of 2 (64x64 images here; the maps FMDA reads are
16x16, the logits' size). Weights are ``torch_parity.jax_variables``'
numpy draws; each JAX step is traced under ``two_pass_batch_variance`` and
compiled once with ``FAST_COMPILE``; SGD as the golden traces.

Tolerances: the losses alone and the discriminator's outputs atol 1e-5
(relative to the largest value where it exceeds 1); the steps' log vars
rtol 2e-4, atol 2e-5; the post-step parameters (the discriminator's too)
rtol 1e-3, atol 3e-5; the BN statistics rtol 2e-3, atol 2e-4 after the
n/(n-1) gap of ROADMAP C2.
"""
import copy
import os.path as osp

import numpy as np
import pytest
import torch

# torch's OpenMP pool must not run beside XLA-CPU in one process
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_data import _source_cfg, isprs_root  # noqa: E402,F401
from test_torch_train import (_assert_bn_stats_close,  # noqa: E402
                              _assert_trees_close, _tree)
from test_torch_uda_family import (_model_cfg, _step_case,  # noqa: E402
                                   _to_jax, _torch_batch, weights)  # noqa: F401
from test_uda_golden_trace import _uda_cfg as pfgst_uda_cfg  # noqa: E402
from torch_parity import (FAST_COMPILE, jax_variables, nchw,  # noqa: E402
                          nhwc, run_jit, two_pass_batch_variance)

from pfst_tpu.apis.train import SupervisedTrainer as JaxTrainer  # noqa: E402
from pfst_tpu.core import optimizers as jax_opt  # noqa: E402
from pfst_tpu.datasets import build_dataset as jax_build_dataset  # noqa: E402
from pfst_tpu.models import build_loss as jax_build_loss  # noqa: E402
from pfst_tpu.models import build_segmentor as jax_segmentor  # noqa: E402
from pfst_tpu.models import build_train_model as jax_train_model  # noqa: E402
from pfst_tpu.models.builder import SEGMENTORS as JAX_SEGMENTORS  # noqa: E402
from pfst_tpu.models.builder import \
    build_discriminator as jax_build_discriminator  # noqa: E402
from pfst_tpu.models.segmentors.domain_adaptor import \
    AdvTrainState as JaxAdvTrainState  # noqa: E402
from pfst_tpu.models.uda.uda_decorator import \
    UDATrainState as JaxUDATrainState  # noqa: E402
from pfst_tpu_torch.apis import (build_algorithm, init_segmentor,  # noqa: E402
                                 single_gpu_test, train_segmentor)
from pfst_tpu_torch.apis.train import (_img_norm_from_pipeline,  # noqa: E402
                                       _metas_key)
from pfst_tpu_torch.core import (build_optimizer, build_optimizers,  # noqa: E402
                                 jax_variables_to_state_dict,
                                 load_jax_train_state)
from pfst_tpu_torch.datasets import build_dataloader, build_dataset  # noqa: E402
from pfst_tpu_torch.models import build_discriminator, build_loss  # noqa: E402
from pfst_tpu_torch.utils import Config  # noqa: E402

MEAN = [123.675, 116.28, 103.53]
STD = [58.395, 57.12, 57.375]
REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
B, HW, C = 2, 64, 6
SGD = dict(type='SGD', lr=1e-2)
DISC = dict(type='FCDiscriminator', num_in_channels=C, ndf=8)
# the generator's weight and the discriminator's learning rate (below)
# large enough that a generator loss taken against the discriminator
# before its update shows in the step
ADV_LOSSES = dict(
    gen_losses=[dict(type='AdvLoss', loss_type='advent', net_type='gen',
                     weights={'loss_gen': 1.0})],
    disc_losses=[dict(type='AdvLoss', loss_type='advent', net_type='disc',
                      weights={'loss_disc_src': 0.5, 'loss_disc_trg': 0.5})])
# the adaptors of the JAX golden traces (tests/test_uda_golden_trace.py,
# tests/test_domain_adaptor_golden_trace.py,
# tests/test_fmda_adaptor_golden_trace.py), FMDA's losses at two levels
ADAPTORS = {
    'DomainAdaptor': dict(type='DomainAdaptor', weight_trg=0.5),
    'DomainAdaptorAdv': dict(type='DomainAdaptorAdv', discriminator=DISC,
                             **ADV_LOSSES),
    'DomainAdaptorV2': dict(
        type='DomainAdaptorV2', weight_trg=0.5, aux_seg_net=None,
        aux_losses=[dict(type='EntropyLoss', loss_type='entropy',
                         weights={'loss_ent': 0.05})]),
    'FMDAAdaptor': dict(
        type='FMDAAdaptor', weight_trg=0.7, pre_feat_shape=(16, 16),
        loss_sim_feat=dict(type='FeatSimLoss', top_k=2, dilation=1,
                           kernel_size=3, sigmas=[4.0, 5.0],
                           weights=[[0.5, 0.3], [0.2, 0.7]])),
    'FMDAAdaptorV2': dict(
        type='FMDAAdaptorV2', weight_trg=0.7,
        loss_sim_feat=dict(type='FeatSimLossV2', top_k=2, dilation=1,
                           kernel_size=3, weights=[[0.5, 0.3], [0.2, 0.7]])),
}


def _segmentor_cfg():
    """The FCN-head golden model with an FCN auxiliary head on level 2."""
    cfg = _model_cfg()
    cfg['auxiliary_head'] = dict(
        type='FCNHead', in_channels=32, in_index=2, channels=8, num_convs=1,
        concat_input=False, dropout_ratio=0.0, num_classes=C,
        norm_cfg=dict(type='BN', requires_grad=True), align_corners=False,
        loss_decode=dict(type='CrossEntropyLoss', use_sigmoid=False,
                         loss_weight=0.4))
    return cfg


def _adaptor_cfg(name):
    seg = _segmentor_cfg()
    seg.pop('type')
    return dict(seg, **copy.deepcopy(ADAPTORS[name]))


def _batch(name, seed=3):
    """NHWC numpy batch under the ``dom1_`` / ``dom2_`` keys: images shifted
    per sample, labels with a band of 255; FMDA's maps (V1: two feature
    maps of 8 and 12 channels at 32x32 and 16x16, which ``pre_feat_shape``
    takes to 16x16 without duplicating a pixel, so that no two
    similarities tie; V2: two 9-channel similarity maps at 16x16) with the
    replay metas."""
    rs = np.random.RandomState(seed)
    shift = np.linspace(-2.0, 2.0, B).reshape(B, 1, 1, 1)

    def images():
        return (rs.randn(B, HW, HW, 3) + shift).astype(np.float32)

    def labels():
        gt = rs.randint(0, C, (B, HW, HW)).astype(np.int32)
        gt[0, :8] = 255
        return gt

    batch = {'dom1_img': images(), 'dom1_gt_semantic_seg': labels(),
             'dom2_img': images(), 'dom2_gt_semantic_seg': labels()}
    if name == 'FMDAAdaptor':
        batch['dom2_feat_a'] = rs.randn(B, 32, 32, 8).astype(np.float32)
        batch['dom2_feat_b'] = rs.randn(B, 16, 16, 12).astype(np.float32)
    elif name == 'FMDAAdaptorV2':
        for k in ('dom2_sim_feat_a', 'dom2_sim_feat_b'):
            batch[k] = rs.rand(B, 16, 16, 9).astype(np.float32)
    if name.startswith('FMDA'):
        batch.update(dom2_rotate_k=np.asarray([1, 2], np.int32),
                     dom2_flip_vertical=np.asarray([0, 1], np.int32),
                     dom2_flip_horizontal=np.asarray([1, 0], np.int32))
    return batch


def _port_batch(batch):
    return {k: nchw(v) if v.ndim == 4 else torch.from_numpy(v)
            for k, v in batch.items()}


def _disc_tree(disc):
    """The port's discriminator in the JAX module's layout."""
    return {f'conv{i}': {
        'kernel': getattr(disc, f'conv{i}').weight.detach().numpy()
        .transpose(2, 3, 1, 0).copy(),
        'bias': getattr(disc, f'conv{i}').bias.detach().numpy().copy()}
        for i in range(5)}


# --------------------------------- losses ----------------------------------
def _close(got, want, what=''):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=1e-5 * max(
        1.0, float(np.abs(want).max())), err_msg=what)


@pytest.mark.parametrize('hw', [(32, 40), (5, 6), (3, 3)],
                         ids=['strided', 'strided-then-small', 'small'])
def test_discriminator_matches_jax(hw):
    """``FCDiscriminator`` on the same weights: the strided branch, a map
    that turns small after the first conv (5 -> 2) and one small from the
    start, where each conv takes stride 1 and XLA's SAME padding (1 before,
    2 after a 4-tap kernel), and the input gradient."""
    rs = np.random.RandomState(1)
    x = rs.randn(2, *hw, C).astype(np.float32)
    jdisc = jax_build_discriminator(dict(DISC))
    variables = jax_variables(jdisc, (1, *hw, C), seed=2)
    disc = build_discriminator(dict(DISC))
    with torch.no_grad():
        for i in range(5):
            conv = getattr(disc, f'conv{i}')
            leaf = variables['params'][f'conv{i}']
            conv.weight.copy_(torch.from_numpy(
                leaf['kernel'].transpose(3, 2, 0, 1).copy()))
            conv.bias.copy_(torch.from_numpy(leaf['bias']))
    xt = nchw(x).requires_grad_()
    out = disc(xt)
    (out**2).sum().backward()

    def f(x):
        y = jdisc.apply(variables, x)
        return (y**2).sum(), y
    (_, want), grad = run_jit(jax.value_and_grad(f, has_aux=True),
                              jnp.asarray(x))
    assert out.shape == (2, 1, 1, 1)
    _close(nhwc(out), want, 'output')
    _close(nhwc(xt.grad), grad, 'input gradient')
    assert float(np.abs(np.asarray(grad)).max()) > 0


def _logits(seed, b=2, h=12, w=14, c=C):
    return (np.random.RandomState(seed).randn(b, h, w, c) * 2).astype(
        np.float32)


@pytest.mark.parametrize('loss_type', ['entropy', 'max_square'])
def test_entropy_loss_matches_jax(loss_type):
    cfg = dict(type='EntropyLoss', loss_type=loss_type,
               weights={'loss_ent': 0.3, 'loss_max_square': 0.7})
    logits = _logits(0)
    lt = nchw(logits).requires_grad_()
    got = build_loss(cfg)({'logits_trg': lt})
    (name, value), = got.items()
    value.backward()
    want, grad = run_jit(jax.value_and_grad(
        lambda x: jax_build_loss(cfg)({'logits_trg': x})[name]),
        jnp.asarray(logits))
    _close(value.item(), want, name)
    _close(nhwc(lt.grad), grad, 'gradient')


@pytest.mark.parametrize('net_type', ['gen', 'disc'])
def test_adv_loss_matches_jax(net_type):
    """``AdvLoss`` through the same discriminator: ``disc`` on detached
    source and target entropy maps (no gradient to the logits), ``gen`` on
    the target's, with its gradient."""
    cfg = dict(ADV_LOSSES[f'{net_type}_losses'][0])
    jdisc = jax_build_discriminator(dict(DISC))
    variables = jax_variables(jdisc, (1, 12, 14, C), seed=4)
    disc = build_discriminator(dict(DISC))
    with torch.no_grad():
        for i in range(5):
            leaf = variables['params'][f'conv{i}']
            getattr(disc, f'conv{i}').weight.copy_(torch.from_numpy(
                leaf['kernel'].transpose(3, 2, 0, 1).copy()))
            getattr(disc, f'conv{i}').bias.copy_(torch.from_numpy(
                leaf['bias']))
    src, trg = _logits(1), _logits(2)
    ts, tt = nchw(src).requires_grad_(), nchw(trg).requires_grad_()
    got = build_loss(cfg)(disc, {'logits_src': ts, 'logits_trg': tt})
    sum(got.values()).backward()

    def f(s, t):
        out = jax_build_loss(cfg)(lambda x: jdisc.apply(variables, x),
                                  {'logits_src': s, 'logits_trg': t})
        return sum(out.values()), out
    (_, want), grads = run_jit(jax.value_and_grad(f, argnums=(0, 1),
                                                  has_aux=True),
                               jnp.asarray(src), jnp.asarray(trg))
    assert sorted(got) == sorted(want)
    for k in got:
        _close(got[k].item(), want[k], k)
    for arg, g in ((ts, grads[0]), (tt, grads[1])):
        _close(np.zeros_like(np.asarray(g)) if arg.grad is None
               else nhwc(arg.grad), g, 'gradient')
    # disc reads both detached, gen the target alone
    assert ts.grad is None and (tt.grad is None) == (net_type == 'disc')


def test_pseudo_label_loss_matches_jax():
    """CE against the argmax of the teacher's logits, bilinearly resized
    from 6x7 to the student's 12x14."""
    cfg = dict(type='PseudoLabelLoss', weights={'loss_pseudo': 0.5})
    trg, ema = _logits(3), _logits(4, h=6, w=7)
    lt = nchw(trg).requires_grad_()
    got = build_loss(cfg)({'logits_trg': lt, 'logits_ema': nchw(ema)})
    got['loss_pseudo'].backward()
    want, grad = run_jit(jax.value_and_grad(
        lambda x, e: jax_build_loss(cfg)({'logits_trg': x, 'logits_ema': e})[
            'loss_pseudo']), jnp.asarray(trg), jnp.asarray(ema))
    _close(got['loss_pseudo'].item(), want)
    _close(nhwc(lt.grad), grad, 'gradient')


@pytest.mark.parametrize('sim_type', ['cosine', 'gaussian'])
def test_local_pseudo_feat_loss_matches_jax(sim_type):
    """Values and gradients with respect to the target logits and the
    source features (its similarity's backward), the features at the
    logits' size and at half of it (nearest-resized first), normal draws
    so that no two similarities tie but at the zero padding."""
    cfg = dict(type='LocalPseudoFeatLoss', top_k=3, dilation=2,
               kernel_size=3, sim_type=sim_type, feat_level=2,
               sigma=30.0 if sim_type == 'cosine' else 4.0,
               weights={'src_pos': 0.3, 'src_neg': 0.2, 'sim_pos': 0.5})
    rs = np.random.RandomState(5)
    logits = _logits(6)
    gt = rs.randint(0, C, (2, 24, 28)).astype(np.int32)
    gt[0, :4] = 255
    x_src = [rs.randn(2, 12, 14, 8).astype(np.float32) for _ in range(2)] + [
        rs.randn(2, 6, 7, 8).astype(np.float32)]
    x_ema = [rs.randn(2, 12, 14, 8).astype(np.float32) for _ in range(3)]
    lt = nchw(logits).requires_grad_()
    xs = nchw(x_src[2]).requires_grad_()
    got = build_loss(cfg)({
        'logits_trg': lt, 'gt_src': torch.from_numpy(gt),
        'x_src': [nchw(a) for a in x_src[:2]] + [xs],
        'x_ema': [nchw(a) for a in x_ema]})
    coef = {n: 1.0 + i for i, n in enumerate(sorted(got))}
    sum(coef[n] * got[n] for n in got).backward()

    def f(logits, x2):
        out = jax_build_loss(cfg)({
            'logits_trg': logits, 'gt_src': jnp.asarray(gt),
            'x_src': [jnp.asarray(a) for a in x_src[:2]] + [x2],
            'x_ema': [jnp.asarray(a) for a in x_ema]})
        return sum(coef[n] * out[n] for n in coef), out
    (_, want), grads = run_jit(jax.value_and_grad(f, argnums=(0, 1),
                                                  has_aux=True),
                               jnp.asarray(logits), jnp.asarray(x_src[2]))
    assert sorted(got) == sorted(want) == ['loss_sim_pos', 'loss_src_neg',
                                           'loss_src_pos']
    for k in got:
        _close(got[k].item(), want[k], k)
        assert float(want[k]) != 0.0, k
    _close(nhwc(lt.grad), grads[0], 'logits gradient')
    _close(nhwc(xs.grad), grads[1], 'feature gradient')


# ------------------------------ one step each ------------------------------
def _jax_state(name, jadaptor, tx):
    variables = jax_variables(jadaptor.model, (1, HW, HW, 3), seed=0)
    if name == 'DomainAdaptorAdv':
        disc = jax_variables(jadaptor.discriminator, (1, 16, 16, C), seed=1)
        return JaxAdvTrainState(
            params=variables['params'], batch_stats=variables['batch_stats'],
            disc_params=disc['params'],
            opt_state=tx['generator'].init(variables['params']),
            disc_opt_state=tx['discriminator'].init(disc['params']),
            step=jnp.zeros((), jnp.int32))
    return JaxUDATrainState(
        params=variables['params'], batch_stats=variables['batch_stats'],
        ema_params={}, ema_batch_stats={},
        opt_state=tx.init(variables['params']), step=jnp.zeros((), jnp.int32))


def _bn_counts(module):
    counts = {}
    hooks = [m.register_forward_hook(
        lambda mod, inp, out, name=n: counts.__setitem__(
            name, inp[0].numel() // inp[0].shape[1]))
        for n, m in module.named_modules()
        if isinstance(m, torch.nn.BatchNorm2d)]
    return counts, hooks


@pytest.mark.parametrize('name', sorted(ADAPTORS))
def test_adaptor_step_matches_jax(name):
    """One SGD step of each adaptor (the adversarial one with the
    reference's ``generator`` / ``discriminator`` optimizer dict, 1e-2 and
    1.0) from the same weights and batch: log vars, the post-step student
    (and discriminator) and the BN statistics after the source and target
    passes."""
    cfg = _adaptor_cfg(name)
    adv = name == 'DomainAdaptorAdv'
    opt_cfg = dict(generator=SGD, discriminator=dict(SGD, lr=1.0)) \
        if adv else SGD
    jadaptor = JAX_SEGMENTORS.build(copy.deepcopy(cfg))
    tx = {k: jax_opt.build_optimizer(v) for k, v in opt_cfg.items()} \
        if adv else jax_opt.build_optimizer(opt_cfg)
    jstate = _jax_state(name, jadaptor, tx)
    batch = _batch(name)
    step_j = jadaptor.make_train_step(tx, MEAN, STD, jit=False)
    with two_pass_batch_variance():
        new_state, log_vars, _ = jax.jit(step_j).lower(
            jstate, batch, jax.random.PRNGKey(3)).compile(FAST_COMPILE)(
                jstate, batch, jax.random.PRNGKey(3))

    algo = build_algorithm(dict(model=cfg), device='cpu')
    assert type(algo).__name__ == name
    state = load_jax_train_state(jstate, algo.init_state(
        torch.Generator().manual_seed(0), build_optimizers(opt_cfg)))
    disc0 = _disc_tree(state.discriminator) if adv else None
    counts, hooks = _bn_counts(state.student)
    state, got = algo.make_train_step(MEAN, STD)(
        state, _port_batch(batch), torch.Generator().manual_seed(1))
    for h in hooks:
        h.remove()
    assert state.step == int(new_state.step) == 1
    assert sorted(got) == sorted(log_vars)
    for k in log_vars:
        np.testing.assert_allclose(got[k].item(), float(log_vars[k]),
                                   rtol=2e-4, atol=2e-5, err_msg=k)
    if name.startswith('FMDA'):
        assert {'loss_sim_pos_1', 'trg.dec.aux.loss_ce'} <= set(got)
        assert float(log_vars['loss_sim_neg_1']) != 0.0
    elif name == 'DomainAdaptorV2':
        assert not any(k.startswith('trg') for k in got)
    elif adv:
        assert float(log_vars['loss_gen']) > 0
        _assert_trees_close(_disc_tree(state.discriminator),
                            new_state.disc_params, 'post-step disc',
                            rtol=1e-3, atol=3e-5)
        moved = [float(np.abs(_disc_tree(state.discriminator)[c]['kernel']
                              - disc0[c]['kernel']).max()) for c in disc0]
        assert all(m > 0 for m in moved), moved
    _assert_bn_stats_close(state.student, jstate, new_state, counts)
    _assert_trees_close(_tree(state.student)[0], new_state.params,
                        'post-step student', rtol=1e-3, atol=3e-5)


def test_adaptors_take_either_key_convention():
    """``img`` / ``target_*`` keys give the step of ``dom1_`` / ``dom2_``
    keys, bitwise; without target labels ``DomainAdaptor`` trains on the
    source alone and FMDA against an all-255 target map."""
    batch = _port_batch(_batch('FMDAAdaptor'))
    renamed = {k.replace('dom1_', '').replace('dom2_gt', 'target_gt')
               .replace('dom2_img', 'target_img').replace('dom2_', ''): v
               for k, v in batch.items()}
    assert {'img', 'target_img', 'target_gt_semantic_seg', 'rotate_k'} <= \
        set(renamed)
    for name in ('DomainAdaptor', 'FMDAAdaptor'):
        results = []
        for b in (batch, renamed, {k: v for k, v in batch.items()
                                   if k != 'dom2_gt_semantic_seg'}):
            algo = build_algorithm(dict(model=_adaptor_cfg(name)),
                                   device='cpu')
            state = algo.init_state(torch.Generator().manual_seed(0),
                                    build_optimizer(SGD))
            results.append(algo.make_train_step(MEAN, STD)(
                state, b, torch.Generator().manual_seed(1))[1])
        assert sorted(results[0]) == sorted(results[1])
        for k in results[0]:
            assert torch.equal(results[0][k], results[1][k]), (name, k)
        trg = [k for k in results[2] if k.startswith('trg')]
        if name == 'DomainAdaptor':
            assert not trg
        else:
            assert results[2]['trg.dec.decode.loss_ce'].item() == 0.0
    with pytest.raises(ValueError, match='DomainAdaptorV2'):
        build_algorithm(dict(model=dict(
            _adaptor_cfg('DomainAdaptor'),
            aux_losses=[dict(type='EntropyLoss')])), device='cpu')


def test_pfgst_with_pseudo_label_aux_losses_matches_jax(weights):  # noqa: F811
    """PFGST with ``LocalPseudoFeatLoss`` (level 2 of the backbone's maps:
    the student's source map, whose similarity's backward runs, and the
    teacher's) and ``PseudoLabelLoss`` as its aux losses: one SGD step
    against JAX's given the port's premix, as
    ``tests/test_torch_uda_family.py::test_step_matches_jax``."""
    uda = dict(pfgst_uda_cfg('all'), use_decoded_feats=False, aux_losses=[
        dict(type='LocalPseudoFeatLoss', top_k=3, dilation=2, kernel_size=3,
             sim_type='cosine', feat_level=2,
             weights={'src_pos': 0.3, 'src_neg': 0.2, 'sim_pos': 0.5}),
        dict(type='PseudoLabelLoss', weights={'loss_pseudo': 0.5})])
    jstate, batch, rng, algo, state, premix, gen = _step_case(weights, uda)
    algo_j = jax_train_model(dict(uda=copy.deepcopy(uda), model=_model_cfg(),
                                  runner=dict(max_iters=100)))
    step_fn = algo_j.make_train_step(jax_opt.build_optimizer(SGD), MEAN,
                                     STD, jit=False)
    jpremix = _to_jax(premix)
    with two_pass_batch_variance():
        new_state, log_vars, _ = jax.jit(
            lambda s, b, r, p: step_fn(s, b, r, premix=p)).lower(
                jstate, batch, rng, jpremix).compile(FAST_COMPILE)(
                    jstate, batch, rng, jpremix)
    counts, hooks = _bn_counts(state.student)
    state, got = algo.make_train_step(MEAN, STD)(
        state, _torch_batch(batch), gen, premix=premix)
    for h in hooks:
        h.remove()
    assert sorted(got) == sorted(log_vars)
    assert {'loss_src_pos', 'loss_src_neg', 'loss_sim_pos',
            'loss_pseudo'} <= set(got)
    for k in log_vars:
        np.testing.assert_allclose(got[k].item(), float(log_vars[k]),
                                   rtol=2e-4, atol=2e-5, err_msg=k)
    _assert_trees_close(_tree(state.teacher)[0], new_state.ema_params,
                        'EMA', rtol=1e-5, atol=1e-6)
    _assert_bn_stats_close(state.student, jstate, new_state, counts)
    _assert_trees_close(_tree(state.student)[0], new_state.params,
                        'post-step student', rtol=1e-3, atol=3e-5)


# ---------------------------------- data -----------------------------------
# the wrappers' datasets: the random geometry of the source pipeline
# (crop, rotation, flips), whose draws the two packages share
PIPELINE = [
    dict(type='LoadImageFromFile'),
    dict(type='LoadAnnotations', reduce_zero_label=True),
    dict(type='RandomCrop', crop_size=(48, 48), cat_max_ratio=0.75),
    dict(type='RandomRotate90', prob=1.0),
    dict(type='RandomFlip', flip_ratio=0.5, direction='vertical'),
    dict(type='Normalize', mean=MEAN, std=STD, to_rgb=True),
    dict(type='DefaultFormatBundle'),
    dict(type='Collect', keys=['img', 'gt_semantic_seg']),
]


def _wrapper_cfgs(root):
    one = _source_cfg(root, PIPELINE)
    two = dict(one, img_dir='img_dir/val', ann_dir='ann_dir/val')
    return {
        'MultiDomainDataset': dict(type='MultiDomainDataset',
                                   datasets=[one, two]),
        'RepeatDataset': dict(type='RepeatDataset', dataset=one, times=3),
        'ConcatDataset': dict(type='ConcatDataset', datasets=[one, two],
                              separate_eval=True),
        'list': [one, two],
        'img_dir-list': dict(one, img_dir=['img_dir/train', 'img_dir/val'],
                             ann_dir=['ann_dir/train', 'ann_dir/val']),
    }


@pytest.mark.parametrize('kind', ['MultiDomainDataset', 'RepeatDataset',
                                  'ConcatDataset', 'list', 'img_dir-list'])
def test_dataset_wrappers_match_jax(isprs_root, kind):  # noqa: F811
    """The wrappers give the JAX package's samples and keys on the same
    files and ``np.random`` seed (images CHW here): ``MultiDomainDataset``
    its ``dom1_`` / ``dom2_`` keys with domain 2 drawn from ``np.random``,
    ``RepeatDataset`` and ``ConcatDataset`` (also as a list of configs and
    as a list-valued ``img_dir``) their lengths and indexing."""
    cfg = _wrapper_cfgs(isprs_root)[kind]
    port, ref = build_dataset(copy.deepcopy(cfg)), \
        jax_build_dataset(copy.deepcopy(cfg))
    assert type(port).__name__ == type(ref).__name__
    assert len(port) == len(ref) > 0 and port.CLASSES == ref.CLASSES
    for idx in (0, len(port) // 2, len(port) - 1):
        out = []
        for ds in (port, ref):
            np.random.seed(idx)
            out.append(ds[idx])
        got, want = out
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            if k.endswith('img_metas'):
                assert {m: np.asarray(x).tolist() for m, x in got[k].items()
                        if m != 'img_norm_cfg'} == \
                    {m: np.asarray(x).tolist() for m, x in v.items()
                     if m != 'img_norm_cfg'}, k
            elif v.ndim == 3:
                assert np.array_equal(got[k], v.transpose(2, 0, 1)), k
            else:
                assert np.array_equal(got[k], v), k
    if kind == 'MultiDomainDataset':
        assert {'dom1_img', 'dom2_img', 'dom2_gt_semantic_seg'} <= set(got)
        draws = set()
        for seed in range(6):
            np.random.seed(seed)
            draws.add(port[0]['dom2_img_metas']['filename'])
        assert len(draws) > 1


# ------------------------------ source-only ---------------------------------
SOURCE_ONLY = osp.join(REPO, 'configs', 'pfst',
                       'source_only_pots_irrg_deeplabv3plus_r50-d8.py')
TINY = {
    'model.backbone.depth': 18, 'model.backbone.base_channels': 8,
    'model.backbone.stem_channels': 8,
    'model.decode_head.in_channels': 64, 'model.decode_head.channels': 16,
    'model.decode_head.c1_in_channels': 8,
    'model.decode_head.c1_channels': 4,
    'model.decode_head.dropout_ratio': 0.0,
    'model.auxiliary_head.in_channels': 32,
    'model.auxiliary_head.channels': 8,
    'model.auxiliary_head.dropout_ratio': 0.0,
}


def _source_only(**options):
    cfg = Config.fromfile(SOURCE_ONLY)
    cfg.merge_from_dict({**TINY, **options})
    return cfg


def test_source_only_step_matches_jax():
    """One step of the source-only config's trainer (its DeepLabV3+ with
    the FCN auxiliary head at the tiny widths, its losses and data keys)
    against the JAX package's ``SupervisedTrainer``, SGD as the golden
    traces: the decode and auxiliary losses and accuracies, the post-step
    parameters and the BN statistics."""
    cfg = _source_only()
    model_cfg = cfg.to_dict()['model']
    assert model_cfg['type'] == 'EncoderDecoder' and 'uda' not in cfg
    jmodel = jax_segmentor(copy.deepcopy(model_cfg))
    variables = jax_variables(jmodel, (1, HW, HW, 3), seed=3)
    rs = np.random.RandomState(8)
    shift = np.linspace(-2.0, 2.0, B).reshape(B, 1, 1, 1)
    batch = {'img': (rs.randn(B, HW, HW, 3) + shift).astype(np.float32),
             'gt_semantic_seg': rs.randint(0, C, (B, HW, HW)).astype(
                 np.int32)}
    batch['gt_semantic_seg'][:, :4] = 255
    tx = jax_opt.build_optimizer(SGD)
    jstate = JaxUDATrainState(
        params=variables['params'], batch_stats=variables['batch_stats'],
        ema_params={}, ema_batch_stats={},
        opt_state=tx.init(variables['params']), step=jnp.zeros((), jnp.int32))
    step_j = JaxTrainer(jmodel).make_train_step(tx, MEAN, STD, jit=False)
    with two_pass_batch_variance():
        new_state, ref, _ = jax.jit(step_j).lower(
            jstate, batch, jax.random.PRNGKey(0)).compile(FAST_COMPILE)(
                jstate, batch, jax.random.PRNGKey(0))
    algo = build_algorithm(cfg, device='cpu')
    state = load_jax_train_state(jstate, algo.init_state(
        torch.Generator().manual_seed(0), build_optimizer(SGD)))
    counts, hooks = _bn_counts(state.student)
    state, got = algo.make_train_step(MEAN, STD)(
        state, _port_batch(batch), torch.Generator().manual_seed(1))
    for h in hooks:
        h.remove()
    assert sorted(got) == sorted(ref) and {'decode.loss_ce',
                                           'aux.loss_ce'} <= set(got)
    for k in ref:
        np.testing.assert_allclose(got[k].item(), float(ref[k]), rtol=2e-4,
                                   atol=2e-5, err_msg=k)
    template = state.student.state_dict()
    before = jax_variables_to_state_dict(variables, template)
    after = jax_variables_to_state_dict(
        {'params': new_state.params, 'batch_stats': new_state.batch_stats},
        template)
    for key, value in template.items():
        name, leaf = key.rsplit('.', 1)
        if leaf == 'num_batches_tracked':
            continue
        want, tol = after[key], dict(rtol=1e-3, atol=3e-5)
        if leaf == 'running_var':
            # one pass: torch's running variance is unbiased
            c = counts[name] / (counts[name] - 1)
            want = c * after[key] - (c - 1) * 0.9 * before[key]
        if leaf.startswith('running'):
            tol = dict(rtol=2e-3, atol=2e-4)
        np.testing.assert_allclose(value.numpy(), want.numpy(),
                                   err_msg=key, **tol)


def _loop_cfg(root, adaptor):
    """The source-only config at the tiny widths on the synthetic ISPRS
    tree of ``tests/test_data.py`` (80x80 tiles, 32x32 crops), 2
    iterations, a checkpoint and an eval at 2; with ``adaptor`` its model
    as a ``DomainAdaptor`` (``weight_trg`` 0.5) on a ``MultiDomainDataset``
    of the train split and the val split."""
    cfg = _source_only(**{
        'data.samples_per_gpu': 2, 'data.workers_per_gpu': 1,
        'data.train.data_root': root, 'data.val.data_root': root,
        'data.test.data_root': root, 'log_config.interval': 1,
        'checkpoint_config.interval': 2, 'evaluation.interval': 2})
    for t in cfg.data.train.pipeline:
        if t['type'] == 'Resize':
            t['img_scale'] = (72, 72)
        if t['type'] in ('RandomCrop', 'Pad'):
            t['crop_size' if t['type'] == 'RandomCrop' else 'size'] = (32, 32)
    for key in ('val', 'test'):
        cfg.data[key].pipeline[1]['img_scale'] = (80, 80)
    if adaptor:
        model = cfg.to_dict()['model']
        model.update(type='DomainAdaptor', weight_trg=0.5)
        train = cfg.to_dict()['data']['train']
        cfg.merge_from_dict({'model': model})
        cfg.data['train'] = dict(
            type='MultiDomainDataset',
            datasets=[train, dict(train, img_dir='img_dir/val',
                                  ann_dir='ann_dir/val')])
        cfg.data['device_normalize'] = True
    return cfg


@pytest.mark.parametrize('adaptor', [False, True],
                         ids=['source_only', 'DomainAdaptor'])
def test_config_trains_and_evaluates_through_the_loop(isprs_root,  # noqa: F811
                                                      tmp_path, adaptor):
    """``train_segmentor`` -> checkpoint -> eval, then the checkpoint
    scored by ``init_segmentor`` + ``single_gpu_test`` (``tools/
    test_torch.py``'s path) to the in-loop mIoU; the adaptor's batches
    carry ``dom1_`` / ``dom2_`` keys over the uint8 wire, normalized on
    the device by their own metas with the first domain's Normalize."""
    cfg = _loop_cfg(isprs_root, adaptor)
    hist = []
    work = str(tmp_path / 'work')
    state = train_segmentor(cfg.copy(), work_dir=work, max_iters_override=2,
                            device='cpu', history=hist)
    logs = [h for h in hist if h['kind'] == 'log']
    assert len(logs) == 2 and all(np.isfinite(v) for h in logs
                                  for v in h['log_vars'].values())
    keys = set(logs[-1]['log_vars'])
    assert ('trg.decode.loss_ce' in keys) == adaptor
    (ev,) = [h for h in hist if h['kind'] == 'eval']
    assert state.step == 2 and type(state).__name__ == 'UDATrainState'
    model = init_segmentor(cfg, osp.join(work, 'iter_2.pth'), device='cpu')
    ds = build_dataset({**cfg.data['val'], 'test_mode': True})
    results = single_gpu_test(model, build_dataloader(ds, 1, 1,
                                                      shuffle=False),
                              pre_eval=True)
    miou = ds.evaluate(results, metric='mIoU')['mIoU']
    assert abs(miou - ev['metrics']['mIoU']) <= 1e-4
    if adaptor:
        assert _img_norm_from_pipeline(cfg)['mean'] == MEAN
        assert [_metas_key(k) for k in ('dom2_img', 'target_img', 'img')] == \
            ['dom2_img_metas', 'target_img_metas', 'img_metas']
