"""The port's training path against the JAX package's, on the CPU.

Weights come from ``torch_parity.jax_variables`` (numpy draws in the JAX
layout) and reach the port through ``load_jax_train_state``. The step is
de-randomised as ``tests/test_uda_golden_trace.py`` does it: no blur,
jitter probability 1.0 (jitter runs iff its draw exceeds it), dropout 0,
and the ClassMix masks come from the JAX draws. The gradient-free half
(``teacher_and_mix``) is held to JAX's on its own; the JAX step, compiled
once (SGD), then takes the port's premix, so it serves both
``thre_type``s. The
JAX programs that run train-mode BN are traced under
``two_pass_batch_variance``: flax's default variance formula is the
reference's own fp32 error, up to 2e-4 in the logits at batch 2.

Tolerances: ``forward_train`` atol 1e-4, rtol 1e-4 (fp32 convolutions in
another order); ClassMix masks exact; the colour, mix and blur arithmetic
atol 1e-5; the LR schedule rtol 1e-6 (fp32 against fp64); the optimizers
atol 1e-7 over 5 steps; the step's log vars rtol 2e-4, atol 2e-5, its EMA
parameters rtol 1e-5, atol 1e-6, the student's BN statistics rtol 2e-3,
atol 2e-4 once the n/(n-1) gap of ROADMAP C2 is accounted for (torch's
running variance is unbiased), and the post-step student parameters rtol
1e-3, atol 3e-5.
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
import optax  # noqa: E402

from conftest import tiny_model_cfg  # noqa: E402
from test_pfgst_loss import WEIGHTS  # noqa: E402
from torch_parity import (FAST_COMPILE, jax_variables, load_port,  # noqa: E402
                          nchw, nhwc, run_jit, shared_by_workers,
                          two_pass_batch_variance)

from pfst_tpu.core import optimizers as jax_opt  # noqa: E402
from pfst_tpu.models import build_segmentor as jax_segmentor  # noqa: E402
from pfst_tpu.models import build_train_model as jax_train_model  # noqa: E402
from pfst_tpu.models.uda import uda_decorator as jax_uda  # noqa: E402
from pfst_tpu.models.utils import dacs_transforms as jdt  # noqa: E402
from pfst_tpu_torch.apis import build_algorithm  # noqa: E402
from pfst_tpu_torch.core import (build_lr_schedule,  # noqa: E402
                                 build_optimizer,
                                 jax_variables_to_state_dict,
                                 load_jax_train_state)
from pfst_tpu_torch.models import build_segmentor, build_train_model  # noqa: E402
from pfst_tpu_torch.models.uda import (PFGST, UDATrainState,  # noqa: E402
                                       maybe_normalize_images)
from pfst_tpu_torch.models.utils import dacs_transforms as dt  # noqa: E402

sys.path.insert(0, osp.join(osp.dirname(__file__), '..', 'tools'))
from convert_torch_checkpoint import convert_state_dict  # noqa: E402

MEAN = [123.675, 116.28, 103.53]
STD = [58.395, 57.12, 57.375]
SIZE, BATCH, ALPHA, TAU, START_STEP = 64, 4, 0.999, 0.35, 3
TOL = dict(atol=1e-4, rtol=1e-4)


def _model_cfg():
    cfg = tiny_model_cfg()
    cfg['decode_head']['dropout_ratio'] = 0.0
    cfg['auxiliary_head']['dropout_ratio'] = 0.0
    return cfg


def _images(rs, b=2, size=SIZE):
    """Normal noise, each image shifted by its own offset: in train mode
    the ASPP image-pool BN normalizes one value per image and channel, so
    at batch 2 its output is +-1 scaled by 1/sqrt(1 + eps/var), and two
    images of equal mean make var tiny and the output ill-conditioned on
    both sides."""
    shift = np.linspace(-2.0, 2.0, b).reshape(b, 1, 1, 1)
    return (rs.randn(b, size, size, 3) + shift).astype(np.float32)


def _labels(rs, b, h, w):
    """Labels of 6 classes in quadrants, a band of 255 across the top."""
    q = np.stack([rs.permutation(6)[:4] for _ in range(b)]).reshape(b, 2, 2)
    gt = q.repeat(h // 2, axis=1).repeat(w // 2, axis=2).astype(np.int32)
    gt[:, :h // 16] = 255
    return gt


# ------------------------------ forward_train ------------------------------
def test_forward_train_matches_jax():
    cfg = _model_cfg()
    jmodel = jax_segmentor(cfg)
    variables = jax_variables(jmodel, (1, SIZE, SIZE, 3))
    rs = np.random.RandomState(0)
    img = _images(rs, b=4)
    gt = rs.randint(0, 6, (4, SIZE, SIZE)).astype(np.int32)
    gt[0, :5] = 255
    weight = rs.uniform(0, 1, (4, SIZE, SIZE)).astype(np.float32)
    with two_pass_batch_variance():
        (ref, ref_states), _ = run_jit(lambda v, i, g, w: jmodel.apply(
            v, i, g, w, train=True, mutable=['batch_stats'],
            method=jmodel.forward_train), variables, img, gt, weight)
    port = load_port(build_segmentor(cfg), variables).train()
    losses, states = port.forward_train(
        nchw(img), torch.from_numpy(gt), torch.from_numpy(weight))
    assert sorted(losses) == sorted(ref) == [
        'aux.acc_seg', 'aux.loss_ce', 'decode.acc_seg', 'decode.loss_ce']
    for k in ref:
        np.testing.assert_allclose(losses[k].item(), float(ref[k]),
                                   err_msg=k, **TOL)
    for k in ('seg_logits', 'decoded_features'):
        np.testing.assert_allclose(nhwc(states[k]), ref_states[k], **TOL)
    for f, rf in zip(states['features'], ref_states['features'],
                     strict=True):
        np.testing.assert_allclose(nhwc(f), rf, **TOL)


# --------------------------- ClassMix and strong aug -----------------------
def test_class_masks_from_jax_scores_are_exact():
    rs = np.random.RandomState(1)
    labels = rs.randint(0, 5, (3, 20, 24)).astype(np.int32)  # class 5 absent
    labels[1, :4] = 255
    for seed in (3, 4):
        key = jax.random.PRNGKey(seed)
        ref = run_jit(lambda k, lb: jdt.get_class_masks(k, lb, 6), key,
                      jnp.asarray(labels))
        scores = np.stack([np.asarray(jax.random.uniform(k, (7,)))
                           for k in jax.random.split(key, 3)])
        out = dt.get_class_masks(torch.from_numpy(scores),
                                 torch.from_numpy(labels), 6)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
        assert 0 < float(out.mean()) < 1
    np.testing.assert_array_equal(
        dt.class_presence(torch.from_numpy(labels), 6).numpy(),
        np.asarray(jdt.class_presence(jnp.asarray(labels), 6)))


def _img01(seed, shape=(2, 20, 24, 3)):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


@pytest.mark.parametrize('name', ['brightness', 'contrast', 'saturation',
                                  'hue'])
def test_color_adjustment_matches_jax(name):
    img = _img01(2)
    factor = np.asarray([-0.17, 0.12] if name == 'hue' else [0.83, 1.18],
                        np.float32)
    jfn = getattr(jdt, f'_adjust_{name}')
    ref = run_jit(jax.vmap(jfn), jnp.asarray(img), jnp.asarray(factor))
    out = getattr(dt, f'adjust_{name}')(nchw(img), torch.from_numpy(factor))
    np.testing.assert_allclose(nhwc(out), ref, atol=1e-5, rtol=0)


def test_hsv_and_one_mix_match_jax():
    img = _img01(3)
    img[0, :3, :3] = 0.4            # gray pixels: delta == 0
    hsv = dt.rgb_to_hsv(nchw(img))
    np.testing.assert_allclose(nhwc(hsv), jdt._rgb_to_hsv(jnp.asarray(img)),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(nhwc(dt.hsv_to_rgb(hsv)), img, atol=1e-5)
    rs = np.random.RandomState(4)
    mask = (rs.rand(2, 20, 24) > 0.5).astype(np.float32)
    other = _img01(5)
    ref = jdt.one_mix(jnp.asarray(mask), jnp.asarray(img),
                      jnp.asarray(other))
    out = dt.one_mix(torch.from_numpy(mask), nchw(img), nchw(other))
    np.testing.assert_allclose(nhwc(out), ref, atol=1e-6, rtol=0)


def test_blur_matches_jax():
    assert dt.blur_kernel_size(512, 512) == \
        jdt.blur_kernel_size(512, 512) == (51, 51)
    sigma = np.asarray([0.31, 1.07], np.float32)
    np.testing.assert_allclose(
        dt.blur_matrix(20, 31, torch.from_numpy(sigma))[1].numpy(),
        run_jit(lambda v: jdt._blur_matrix(20, 31, v), sigma[1]), atol=1e-6)
    img = np.random.RandomState(6).randn(2, 40, 56, 3).astype(np.float32)
    ksize = jdt.blur_kernel_size(40, 56)
    ref = run_jit(jax.vmap(lambda im, s: jdt.gaussian_blur_single(
        im, s, ksize)), jnp.asarray(img), jnp.asarray(sigma))
    out = dt.gaussian_blur(nchw(img), torch.from_numpy(sigma), ksize)
    np.testing.assert_allclose(nhwc(out), ref, atol=1e-5, rtol=0)


def test_strong_transform_matches_jax_on_its_draws():
    """The whole mix + jitter + blur, with the port given the numbers the
    JAX ``strong_transform`` draws from its keys."""
    b, h, w, s = 2, 32, 40, 0.2
    rs = np.random.RandomState(7)
    src = rs.randn(b, h, w, 3).astype(np.float32)
    trg = rs.randn(b, h, w, 3).astype(np.float32)
    gt = _labels(rs, b, h, w).astype(np.float32)
    pl = rs.randint(0, 6, (b, h, w)).astype(np.float32)
    mask = (rs.rand(b, h, w) > 0.5).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(11), b)
    mean, std = jnp.asarray(MEAN), jnp.asarray(STD)

    def jax_one(k, m, a, t, g, p):
        return jdt.strong_transform(k, m, (a, t), (g, p), jitter_gate=0.9,
                                    blur_gate=0.7, color_jitter_s=s,
                                    color_jitter_p=0.2, mean=mean, std=std)

    ref_img, ref_lbl = run_jit(jax.vmap(jax_one), keys, mask, src, trg, gt,
                               pl)
    jitter, sigma = [], []
    for k in keys:
        kj, kb = jax.random.split(k)
        k4 = jax.random.split(kj, 4)
        jitter.append([float(jax.random.uniform(
            k4[i], (), minval=lo, maxval=hi)) for i, (lo, hi) in enumerate(
                [(1 - s, 1 + s)] * 3 + [(-s, s)])])
        sigma.append(float(jax.random.uniform(jax.random.fold_in(kb, 1), (),
                                              minval=0.15, maxval=1.15)))
    draws = dict(jitter_gate=0.9, blur_gate=0.7,
                 jitter=torch.tensor(jitter), blur_sigma=torch.tensor(sigma))
    out_img, out_lbl = dt.strong_transform(
        draws, torch.from_numpy(mask), (nchw(src), nchw(trg)),
        (torch.from_numpy(gt), torch.from_numpy(pl)), color_jitter_p=0.2,
        mean=MEAN, std=STD)
    np.testing.assert_allclose(nhwc(out_img), ref_img, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(out_lbl.numpy(), np.asarray(ref_lbl))


def test_draws_are_seeded_and_in_range():
    a = dt.sample_strong_draws(torch.Generator().manual_seed(0), 3, 6)
    b = dt.sample_strong_draws(torch.Generator().manual_seed(0), 3, 6)
    for k in a:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
    assert a['class_scores'].shape == (3, 7) and a['jitter'].shape == (3, 4)
    assert ((a['jitter'][:, :3] >= 0.8) & (a['jitter'][:, :3] <= 1.2)).all()
    assert (a['jitter'][:, 3].abs() <= 0.2).all()
    assert ((a['blur_sigma'] >= 0.15) & (a['blur_sigma'] <= 1.15)).all()
    assert dt.sample_strong_draws(torch.Generator(), 1, 6,
                                  blur=False)['blur_gate'] == 0.0


def test_maybe_normalize_images_matches_jax():
    img = np.random.RandomState(8).randint(0, 256, (2, 6, 5, 3)).astype(
        np.uint8)
    ref = jax_uda.maybe_normalize_images(
        {'img': jnp.asarray(img)}, jnp.asarray(MEAN), jnp.asarray(STD))
    out = maybe_normalize_images({'img': nchw(img), 'gt': 1}, MEAN, STD)
    np.testing.assert_allclose(nhwc(out['img']), ref['img'], atol=1e-5)
    f32 = torch.zeros(1, 3, 2, 2)
    assert maybe_normalize_images({'img': f32}, MEAN, STD)['img'] is f32


# ------------------------------- optimizers --------------------------------
ADAMW_40K_LR = dict(policy='poly', warmup='linear', warmup_iters=1500,
                    warmup_ratio=1e-6, power=1.0, min_lr=0.0, by_epoch=False)


@pytest.mark.parametrize('lr_config', [
    ADAMW_40K_LR,
    dict(policy='poly', power=0.9, min_lr=1e-6),
    dict(policy='step', step=[1000, 30000], gamma=0.5, warmup='constant',
         warmup_iters=500, warmup_ratio=0.1),
    # gamma exact in fp32, so that gamma**step compares to rtol 1e-6
    dict(policy='exp', gamma=1 - 2**-13, warmup='exp', warmup_iters=500),
    dict(policy='inv', gamma=1e-4, power=0.75),
    dict(policy='CosineAnnealing', min_lr_ratio=0.01),
    dict(policy='linear', min_lr=1e-6),
    dict(policy='fixed')], ids=lambda c: c['policy'] + str(c.get('warmup')))
def test_lr_schedule_matches_jax(lr_config):
    steps = [0, 1, 7, 499, 500, 750, 1499, 1500, 1501, 20000, 39999, 40000,
             41000]
    ref = jax_opt.build_lr_schedule(lr_config, 6e-5, 40000)
    got = build_lr_schedule(lr_config, 6e-5, 40000)
    want = np.asarray([float(ref(s)) for s in steps])
    # beyond adamw_40k's poly, JAX's fp32 formulas may cancel (linear:
    # base + (target - base) * progress): allow its resolution at base_lr
    atol = 0 if lr_config is ADAMW_40K_LR else 6e-5 * np.finfo(np.float32).eps
    np.testing.assert_allclose([got(s) for s in steps], want, rtol=1e-6,
                               atol=atol)
    assert build_lr_schedule(None, 6e-5, 40000) == 6e-5


@pytest.mark.parametrize('opt_cfg,grad_clip', [
    (dict(type='AdamW', lr=6e-5, betas=(0.9, 0.999), weight_decay=0.01),
     None),
    (dict(type='AdamW', lr=1e-3, eps=1e-6, weight_decay=0.05),
     dict(max_norm=0.5)),
    (dict(type='Adam', lr=1e-3, betas=(0.8, 0.99)), None),
    (dict(type='SGD', lr=0.01, momentum=0.9, weight_decay=5e-4), None),
    (dict(type='SGD', lr=0.01, momentum=0.9, nesterov=True), None)],
    ids=['adamw_40k', 'adamw-clip', 'adam', 'sgd', 'sgd-nesterov'])
def test_optimizer_matches_optax(opt_cfg, grad_clip):
    """Five updates on a toy tree, with a schedule that moves in them."""
    lr_config = dict(policy='poly', warmup='linear', warmup_iters=3,
                     warmup_ratio=0.1, power=1.0)
    rs = np.random.RandomState(9)
    params = {'a': rs.randn(3, 4).astype(np.float32) * 0.2,
              'b': rs.randn(5).astype(np.float32) * 0.2}
    tx = jax_opt.build_optimizer(opt_cfg, lr_config, 10, grad_clip)
    jparams = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jparams)
    port = {k: torch.from_numpy(v.copy()).requires_grad_()
            for k, v in params.items()}
    opt = build_optimizer(opt_cfg, lr_config, 10, grad_clip)(
        list(port.values()))
    schedule = build_lr_schedule(lr_config, opt_cfg['lr'], 10)
    update = jax.jit(tx.update)
    for step in range(5):
        assert abs(opt.lr - schedule(step)) <= 1e-12
        grads = {k: rs.randn(*v.shape).astype(np.float32)
                 for k, v in params.items()}
        updates, opt_state = update(jax.tree.map(jnp.asarray, grads),
                                    opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.zero_grad()
        for k, p in port.items():
            p.grad = torch.from_numpy(grads[k])
        opt.step()
    for k, p in port.items():
        np.testing.assert_allclose(p.detach().numpy(), jparams[k],
                                   atol=1e-7, rtol=0, err_msg=k)


# ------------------------------ the PFGST step -----------------------------
def _uda_cfg(thre_type, denorm='mean_std'):
    # with 'none' the jitter runs (probability 0), on the JAX draws
    return dict(
        type='PFGST', alpha=ALPHA, pseudo_threshold=TAU,
        pseudo_weight_ignore_top=0, pseudo_weight_ignore_bottom=0,
        imnet_feature_dist_lambda=0, mix='class', blur=False,
        color_jitter_strength=0.2,
        color_jitter_probability=1.0 if denorm == 'mean_std' else 0.0,
        thre_type=thre_type, trg_loss_weight=1.0, use_decoded_feats=True,
        strong_aug_denorm_type=denorm,
        aux_losses=[dict(type='PFGSTLoss', kernel_size=3, dilation=2,
                         top_k=3, weights=WEIGHTS, sim_type='cosine',
                         feat_level=None, detach_unfold=True)])


def _train_cfg(thre_type, denorm='mean_std'):
    return dict(uda=_uda_cfg(thre_type, denorm), model=_model_cfg(),
                runner=dict(max_iters=100))


SGD = dict(type='SGD', lr=1e-2)


@pytest.fixture(scope='module')
def jax_state():
    """A JAX train state at step 3 (student and teacher drawn from two
    seeds) and the batch."""
    algo = jax_train_model(_train_cfg('all'))
    student = jax_variables(algo.model, (1, SIZE, SIZE, 3), seed=0)
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
    rs = np.random.RandomState(0)
    batch = {'img': _images(rs, BATCH),
             'gt_semantic_seg': _labels(rs, BATCH, SIZE, SIZE),
             'target_img': _images(rs, BATCH),
             'target_img_strong_aug': _images(rs, BATCH)}
    return algo, tx, state, batch


@pytest.fixture(scope='module')
def jax_step(jax_state, tmp_path_factory):
    """The JAX step's new state, log vars and visualisation states
    (``collect_vis``) for each ``thre_type`` of
    ``test_pfgst_step_matches_jax``, given the port's premix of that
    ``thre_type`` (the gradient-free half): the step with its premix as an
    argument does not depend on ``thre_type``, so it compiles once, and
    runs once a test run."""
    def compute():
        algo, tx, state, batch = jax_state
        step_fn = algo.make_train_step(tx, MEAN, STD, jit=False,
                                       collect_vis=True)
        rng = jax.random.PRNGKey(7)
        premix = {t: _to_jax(_port_premix(t, state, batch, rng)[2])
                  for t in ('all', 'part')}
        with two_pass_batch_variance():
            step = jax.jit(lambda s, b, r, p: step_fn(
                s, b, r, premix=p)).lower(
                    state, batch, rng, premix['all']).compile(FAST_COMPILE)
        return {t: jax.device_get(step(state, batch, rng, p))
                for t, p in premix.items()}

    return shared_by_workers(tmp_path_factory, 'train_jax_step', compute)


def _port_state(thre_type, jstate, denorm='mean_std'):
    algo = build_train_model(_train_cfg(thre_type, denorm), device='cpu')
    state = algo.init_state(torch.Generator().manual_seed(0),
                            build_optimizer(SGD))
    return algo, load_jax_train_state(jstate, state)


def _torch_batch(batch):
    return {k: torch.from_numpy(v) if v.ndim == 3 else nchw(v)
            for k, v in batch.items()}


def _port_premix(thre_type, jstate, batch, rng, denorm='mean_std'):
    """The port's teacher_and_mix on its EMA-updated teacher, with the
    ClassMix scores the JAX step draws from ``rng`` (``pfgst.py:203,240``,
    ``dacs_transforms.py:59,78``); returns (algo, state, premix, gen)."""
    algo, state = _port_state(thre_type, jstate, denorm)
    gen = torch.Generator().manual_seed(0)
    draws = algo.sample_draws(gen, BATCH)
    _, _, k_mix, k_gate_j, _, k_strong = jax.random.split(rng, 6)
    if denorm != 'mean_std':
        draws['jitter_gate'] = float(jax.random.uniform(k_gate_j, ()))
        s = algo.color_jitter_s
        draws['jitter'] = torch.tensor([[float(jax.random.uniform(
            k4, (), minval=lo, maxval=hi)) for k4, (lo, hi) in zip(
                jax.random.split(jax.random.split(k)[0], 4),
                [(1 - s, 1 + s)] * 3 + [(-s, s)])]
            for k in jax.random.split(k_strong, BATCH)])
    draws['class_scores'] = torch.from_numpy(np.stack([
        np.asarray(jax.random.uniform(k, (7,)))
        for k in jax.random.split(k_mix, BATCH)]))
    updated = UDATrainState(student=state.student,
                            teacher=copy.deepcopy(state.teacher),
                            optimizer=None, step=state.step)
    premix = algo.teacher_and_mix(algo.ema_update(updated, ALPHA),
                                  _torch_batch(batch), draws, MEAN, STD)
    return algo, state, premix, gen


def _to_jax(premix):
    return {k: jnp.asarray(nhwc(v) if v.ndim == 4 else
                           v.numpy().astype(np.int32 if 'label' in k or
                                            'lbl' in k else np.float32))
            for k, v in premix.items()}


@pytest.mark.parametrize('thre_type,denorm', [
    ('all', 'mean_std'), ('part', 'mean_std'), ('all', 'none')],
    ids=['all', 'part', 'all-denorm_none'])
def test_teacher_and_mix_matches_jax(jax_state, thre_type, denorm):
    """Teacher forward, pseudo-labels and their weight, ClassMix and the
    mixed batch, against the JAX ``teacher_and_mix`` on the same
    EMA-updated teacher; ``strong_aug_denorm_type='none'`` (the SeasonNet
    config) jitters the normalized images as they are."""
    algo_j, _, jstate, batch = jax_state
    rng = jax.random.PRNGKey(7)
    a = min(1.0 - 1.0 / (START_STEP + 1), ALPHA)
    ema = jax.tree.map(lambda e, p: a * np.asarray(e) + (1 - a) *
                       np.asarray(p), jstate.ema_params, jstate.params)
    algo = jax_train_model(_train_cfg(thre_type, denorm))
    mean, std = jnp.asarray(MEAN), jnp.asarray(STD)
    with two_pass_batch_variance():
        ref = run_jit(lambda e, eb, b, r: algo.teacher_and_mix(
            e, eb, b, r, mean, std), ema, jstate.ema_batch_stats, batch,
            rng)
    premix = _port_premix(thre_type, jstate, batch, rng, denorm)[2]
    np.testing.assert_array_equal(premix['mix_masks'].numpy(),
                                  np.asarray(ref['mix_masks']))
    assert 0 < float(premix['mix_masks'].mean()) < 1
    np.testing.assert_allclose(nhwc(premix['ema_logits']),
                               ref['ema_logits'], **TOL)
    np.testing.assert_allclose(nhwc(premix['ema_feats']), ref['ema_feats'],
                               **TOL)
    # the jitter's colour arithmetic, where it runs: atol 1e-5
    np.testing.assert_allclose(nhwc(premix['mixed_img']), ref['mixed_img'],
                               atol=1e-6 if denorm == 'mean_std' else 1e-5)
    np.testing.assert_allclose(premix['pseudo_weight'].numpy(),
                               ref['pseudo_weight'], atol=1e-6)
    for k in ('pseudo_label', 'mixed_lbl'):
        assert (premix[k].numpy() == np.asarray(ref[k])).mean() > 0.999


@pytest.mark.parametrize('thre_type', ['all', 'part'])
def test_pfgst_step_matches_jax(jax_state, jax_step, thre_type):
    """One SGD step of the port against the JAX step given the port's
    premix (the gradient-free half, held to JAX's by
    ``test_teacher_and_mix_matches_jax``)."""
    _, _, jstate, batch = jax_state
    rng = jax.random.PRNGKey(7)
    algo, state, premix, gen = _port_premix(thre_type, jstate, batch, rng)
    new_state, log_vars, _ = jax_step[thre_type]
    assert state.step == START_STEP
    # the number of values each BN normalizes over, for the n/(n-1) gap
    counts = {}
    hooks = [m.register_forward_hook(
        lambda mod, inp, out, name=name: counts.__setitem__(
            name, inp[0].numel() // inp[0].shape[1]))
        for name, m in state.student.named_modules()
        if isinstance(m, torch.nn.BatchNorm2d)]
    state, got = algo.make_train_step(MEAN, STD)(
        state, _torch_batch(batch), gen, premix=premix)
    for h in hooks:
        h.remove()
    assert state.step == int(new_state.step) == START_STEP + 1
    assert sorted(got) == sorted(log_vars)
    assert float(log_vars['loss_sim_pos']) != 0.0
    for k in log_vars:
        np.testing.assert_allclose(got[k].item(), float(log_vars[k]),
                                   rtol=2e-4, atol=2e-5, err_msg=k)
    params, _ = _tree(state.student)
    _assert_trees_close(_tree(state.teacher)[0], new_state.ema_params,
                        'EMA', rtol=1e-5, atol=1e-6)
    _assert_bn_stats_close(state.student, jstate, new_state, counts)
    _assert_trees_close(params, new_state.params, 'post-step student',
                        rtol=1e-3, atol=3e-5)


def _tree(module):
    params, stats, _ = convert_state_dict(module.state_dict())
    return params, stats


def _assert_trees_close(got, want, what, **tol):
    flat = dict(jax.tree_util.tree_leaves_with_path(want))
    leaves = jax.tree_util.tree_leaves_with_path(got)
    assert len(leaves) == len(flat)
    for path, leaf in leaves:
        np.testing.assert_allclose(np.asarray(leaf), np.asarray(flat[path]),
                                   err_msg=f'{what} {path}', **tol)


def _assert_bn_stats_close(student, jstate, new_state, counts):
    """The student's running statistics after the source and the mixed
    pass. torch updates the running variance with the unbiased batch
    variance and flax with the biased one; with c = n/(n-1) for a BN over
    n values and momentum m, two passes from v0 give torch's
    c * v_jax - (c - 1) (1 - m)^2 v0, which is what is compared."""
    template = student.state_dict()
    before = jax_variables_to_state_dict(
        {'params': jstate.params, 'batch_stats': jstate.batch_stats},
        template)
    after = jax_variables_to_state_dict(
        {'params': new_state.params, 'batch_stats': new_state.batch_stats},
        template)
    m = 0.1
    for key, value in template.items():
        name, leaf = key.rsplit('.', 1)
        if leaf == 'running_mean':
            want = after[key]
        elif leaf == 'running_var':
            c = counts[name] / (counts[name] - 1)
            want = c * after[key] - (c - 1) * (1 - m)**2 * before[key]
        else:
            continue
        np.testing.assert_allclose(value.numpy(), want.numpy(), rtol=2e-3,
                                   atol=2e-4, err_msg=f'BN stat {key}')


def test_train_state_carry_round_trip(jax_state):
    _, _, jstate, _ = jax_state
    _, state = _port_state('all', jstate)
    assert state.step == START_STEP
    for module, params, stats in (
            (state.student, jstate.params, jstate.batch_stats),
            (state.teacher, jstate.ema_params, jstate.ema_batch_stats)):
        got_p, got_s = _tree(module)
        _assert_trees_close(got_p, params, 'params', rtol=0, atol=0)
        _assert_trees_close(got_s, stats, 'stats', rtol=0, atol=0)
    cut = jstate.replace(ema_params={
        k: v for k, v in jstate.ema_params.items() if k != 'aux_heads_0'})
    with pytest.raises(KeyError, match='auxiliary_head.conv_seg.weight'):
        load_jax_train_state(cut, state)
    # the LR schedule resumes at the carried step, as optax's count does
    algo = build_train_model(_train_cfg('all'), device='cpu')
    adamw = algo.init_state(torch.Generator().manual_seed(0), build_optimizer(
        dict(type='AdamW', lr=6e-5, weight_decay=0.01), ADAMW_40K_LR, 40000))
    opt = load_jax_train_state(jstate, adamw).optimizer
    ref = jax_opt.build_lr_schedule(ADAMW_40K_LR, 6e-5, 40000)
    assert float(ref(START_STEP)) > 2 * float(ref(0))
    for step in (START_STEP, START_STEP + 1):
        np.testing.assert_allclose(opt.lr, float(ref(step)), rtol=1e-6)
        opt.step()


# ------------------------ what the port does not have ------------------------
class _SelfTraining(PFGST):
    target_self_training = True


@pytest.mark.parametrize('case', [
    'fdist', 'grad_magnitude', 'self_training', 'collect_vis',
    'paramwise_cfg', 'cumulative_iters', 'skip_nonfinite', 'ohem'])
def test_waiting_options_raise(case):
    """What the port does not have raises. The PFGST hooks ``fdist``,
    ``grad_magnitude`` and ``self_training`` waited for the UDA family and
    are ported now: they build instead (their steps are held to JAX in
    ``tests/test_torch_uda_family.py``); so do the optimizer options
    ``paramwise_cfg``, ``cumulative_iters`` and ``skip_nonfinite``, which
    waited for the domain adaptors (held to optax in
    ``tests/test_torch_optim.py``), and ``collect_vis``, which waited for
    the hooks that read it: the supervised step returns the JAX step's
    triple with no states (the PFGST step's are held to JAX in
    ``tests/test_torch_a12_rest.py``)."""
    cfg = _train_cfg('all')
    uda = dict(cfg['uda'], model=cfg['model'], device='cpu')
    if case == 'fdist':
        state = PFGST(**dict(uda, imnet_feature_dist_lambda=0.1)).init_state(
            torch.Generator().manual_seed(0), build_optimizer(SGD))
        assert not any(p.requires_grad for p in state.imnet.parameters())
        want = state.student.state_dict()
        for k, v in state.imnet.state_dict().items():
            assert torch.equal(v, want[k]), k
        return
    if case == 'grad_magnitude':
        assert PFGST(**dict(uda, print_grad_magnitude=True)
                     ).print_grad_magnitude
        return
    if case == 'self_training':
        assert _SelfTraining(**uda).target_self_training
        return
    if case == 'paramwise_cfg':
        state = PFGST(**uda).init_state(
            torch.Generator().manual_seed(0), build_optimizer(dict(
                SGD, paramwise_cfg=dict(custom_keys={
                    'backbone': dict(lr_mult=0.1)}))))
        groups = state.optimizer.optimizer.param_groups
        assert sorted(g['lr'] for g in groups) == pytest.approx(
            [0.1 * SGD['lr'], SGD['lr']])
        backbone = {id(p) for p in state.student.backbone.parameters()}
        slow = min(groups, key=lambda g: g['lr'])
        assert {id(p) for p in slow['params']} == backbone
        return
    if case in ('cumulative_iters', 'skip_nonfinite'):
        p = torch.ones(3, requires_grad=True)
        opt = build_optimizer(SGD, **{case: 2})([p])
        grads = [torch.full((3,), 2.0), torch.full((3,), 4.0)]
        if case == 'skip_nonfinite':
            grads[0] = torch.tensor([1.0, float('nan'), 1.0])
        applied = []
        for g in grads:
            p.grad = g
            applied.append(opt.step())
        assert applied == [False, True]
        # the mean (3) applied once; or the finite step alone (4)
        want = 1.0 - SGD['lr'] * (3.0 if case == 'cumulative_iters' else 4.0)
        assert torch.allclose(p.detach(), torch.full((3,), want))
        return
    if case == 'collect_vis':
        trainer = build_algorithm({'model': _model_cfg()}, device='cpu')
        state = trainer.init_state(torch.Generator().manual_seed(0),
                                   build_optimizer(SGD))
        rs = np.random.RandomState(0)
        out = trainer.make_train_step(MEAN, STD, collect_vis=True)(
            state, {'img': nchw(_images(rs, 2, 32)),
                    'gt_semantic_seg': torch.from_numpy(
                        rs.randint(0, 6, (2, 32, 32)))},
            torch.Generator().manual_seed(0))
        assert len(out) == 3 and out[2] == {} and out[0].step == 1
        assert np.isfinite(out[1]['loss'].item())
        return
    model_cfg = _model_cfg()
    model_cfg['decode_head']['sampler'] = dict(type='OHEMPixelSampler')
    with pytest.raises(NotImplementedError):
        build_segmentor(model_cfg).forward_train(
            torch.zeros(1, 3, 32, 32), torch.zeros(1, 32, 32))


def test_build_train_model_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        build_train_model(_train_cfg('all'))
