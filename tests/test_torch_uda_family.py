"""The port's UDA family (DACS, PFST V1-V4, PGST x4, FMDA x2), its losses,
its replay and its data pieces against the JAX package's, on the CPU.

The algorithms' configs, the batch (2 of 128x128; the trajectory's 2 of
64x64, the JAX trajectory's 96x96 cut for time) and the de-randomisation (no blur, jitter probability 1.0,
dropout 0) are the JAX golden traces'; the ClassMix masks come from the
JAX draws. The tiny model (``_model_cfg``) is the golden traces'
depth-18 ResNetV1c with an FCN decode head in place of their DeepLabV3+
heads: the ASPP image pool's train-mode BN normalizes one value an image,
which at batch 2 puts JAX's teacher logits up to 1.4e-4 off the port's,
over these tolerances, and the smaller head halves the JAX compiles. The
images are shifted per sample and the labels are blocks with edges off
the feature stride (``_batch``), so that the target mask keeps interior
pixels and a blend at feature resolution differs from one at full
resolution. Weights are ``torch_parity.jax_variables``' numpy draws; the
JAX programs that run train-mode BN are traced under
``two_pass_batch_variance`` and compiled once each with
``FAST_COMPILE``.

* Each new loss, both similarity types: values and the gradients with
  respect to the student's inputs. The features are drawn at the logits'
  resolution and from a normal distribution, so no feature vector is
  exactly zero (ROADMAP C2) and no two similarities tie but at the zero
  padding, where the tied neighbors carry equal values.
* ``teacher_and_mix`` of DACS (the plain view), FMDA and PGSTTRG (both
  self-training views), PGSTMixFeat (the weak mix) and PFSTV4 (the
  replay): JAX's runs with its teacher forward as one compiled program.
* One SGD step of PGST (the blend), PGSTMixFeat, FMDA, PFST and DACS (the
  feature distance and ``grad_mag``) against JAX's given the port's premix,
  as ``test_pfgst_step_matches_jax``; the other names take the step of the
  composition they share.
* ``transform_by_metas`` for every rotation and flip, ``KeepOriImage``, the
  replay metas and ``UDADataset._merge`` against the JAX package's samples.
* The 12-step PFGST trajectory at the ``adamw_40k`` values (ROADMAP A6).

Tolerances are ``tests/test_torch_train.py``'s: log vars rtol 2e-4, atol
2e-5; EMA rtol 1e-5, atol 1e-6; BN statistics rtol 2e-3, atol 2e-4 after
the n/(n-1) gap; post-step parameters rtol 1e-3, atol 3e-5; the teacher
outputs atol 1e-4, rtol 1e-4. The trajectory keeps
``tests/test_uda_trajectory.py``'s calibrated bounds.
"""
import copy

import numpy as np
import pytest
import torch

# torch's OpenMP pool must not run beside XLA-CPU in one process
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import test_fmda_golden_trace as golden_fmda  # noqa: E402
import test_fmdamix_golden_trace as golden_fmdamix  # noqa: E402
import test_pfst_base_golden_trace as golden_pfst  # noqa: E402
import test_pfstv4_golden_trace as golden_pfstv4  # noqa: E402
import test_pgst_golden_trace as golden_pgst  # noqa: E402
import test_pgstmixfeat_golden_trace as golden_pgstmixfeat  # noqa: E402
import test_pgsttrg_golden_trace as golden_pgsttrg  # noqa: E402
import test_pgstv4_golden_trace as golden_pgstv4  # noqa: E402
from test_data import (ORI_TARGET_PIPELINE, SOURCE_PIPELINE,  # noqa: E402
                       _source_cfg, isprs_root)
from test_torch_train import (_assert_bn_stats_close,  # noqa: E402
                              _assert_trees_close, _tree)
from test_uda_golden_trace import (ALPHA, MEAN, START_STEP, STD,  # noqa: E402
                                   TAU, _merge)
from test_uda_golden_trace import _uda_cfg as pfgst_uda_cfg  # noqa: E402
from test_uda_trajectory import (BETAS, N_STEPS, WD,  # noqa: E402
                                 mmcv_poly_warmup_lr)
from torch_parity import (FAST_COMPILE, jax_variables,  # noqa: E402
                          nchw, nhwc, run_jit, two_pass_batch_variance)

from pfst_tpu.core import optimizers as jax_opt  # noqa: E402
from pfst_tpu.datasets import build_dataset as jax_build_dataset  # noqa: E402
from pfst_tpu.models import build_loss as jax_build_loss  # noqa: E402
from pfst_tpu.models import build_train_model as jax_train_model  # noqa: E402
from pfst_tpu.models.uda import uda_decorator as jax_uda  # noqa: E402
from pfst_tpu.models.utils import pfst_transforms as jax_replay  # noqa: E402
from pfst_tpu_torch.core import (build_optimizer,  # noqa: E402
                                 load_checkpoint, load_jax_train_state,
                                 load_weights_into_state, restore_state,
                                 save_checkpoint)
from pfst_tpu_torch.datasets import DataLoader, build_dataset  # noqa: E402
from pfst_tpu_torch.models import build_loss, build_train_model  # noqa: E402
from pfst_tpu_torch.models.uda import UDATrainState  # noqa: E402
from pfst_tpu_torch.models.utils.pfst_transforms import (  # noqa: E402
    transform_by_metas)
from pfst_tpu_torch.ops import resize  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
B, HW, NUM_CLASSES = 2, 128, 6
SGD = dict(type='SGD', lr=1e-2)
REPLAY_KEYS = ('rotate_k', 'flip_vertical', 'flip_horizontal')

# the JAX golden traces' configs (DACS's is the one of
# ``test_uda_golden_trace.py::test_dacs_one_iteration_golden_trace``, with
# ``print_grad_magnitude``)
DACS_CFG = dict(
    type='DACS', alpha=ALPHA, pseudo_threshold=TAU,
    pseudo_weight_ignore_top=0, pseudo_weight_ignore_bottom=0,
    imnet_feature_dist_lambda=0.01, imnet_feature_dist_classes=[2, 3],
    mix='class', blur=False, color_jitter_strength=0.2,
    color_jitter_probability=1.0, print_grad_magnitude=True)
UDA_CFGS = {
    'DACS': DACS_CFG,
    'PFST': golden_pfst._uda_cfg(),
    'PFSTV2': dict(golden_pfst._uda_cfg(), type='PFSTV2'),
    'PFSTV3': dict(golden_pfst._uda_cfg(), type='PFSTV3'),
    'PFSTV4': golden_pfstv4._uda_cfg(),
    'PGST': golden_pgst._uda_cfg(),
    'PGSTTRG': golden_pgsttrg._uda_cfg(),
    'PGSTV4': golden_pgstv4._uda_cfg(),
    'PGSTMixFeat': golden_pgstmixfeat._uda_cfg(),
    'FMDA': golden_fmda._uda_cfg(),
    'FMDAMix': golden_fmdamix._uda_cfg(),
}


def _model_cfg():
    """The golden traces' backbone (``test_uda_golden_trace._model_cfg``)
    under an FCN decode head on its first and last levels (resized to the
    first and concatenated), so that the logits come at stride 4 as the
    golden traces' DeepLabV3+ head gives them; 6 classes."""
    norm = dict(type='BN', requires_grad=True)
    loss = dict(type='CrossEntropyLoss', use_sigmoid=False, loss_weight=1.0)
    return dict(
        type='EncoderDecoder',
        backbone=dict(type='ResNetV1c', depth=18, num_stages=4,
                      base_channels=8, stem_channels=8,
                      out_indices=(0, 1, 2, 3), dilations=(1, 1, 2, 4),
                      strides=(1, 2, 1, 1), norm_cfg=norm,
                      contract_dilation=True),
        decode_head=dict(type='FCNHead', in_channels=72, in_index=(0, 3),
                         input_transform='resize_concat',
                         channels=16, num_convs=1, concat_input=False,
                         dropout_ratio=0.0, num_classes=NUM_CLASSES,
                         norm_cfg=norm, align_corners=False,
                         loss_decode=loss),
        train_cfg=dict(), test_cfg=dict(mode='whole'))


def _train_cfg(uda, max_iters=100):
    return dict(uda=copy.deepcopy(uda), model=_model_cfg(),
                runner=dict(max_iters=max_iters))


def _batch(seed, size=HW, replay=False, b=B):
    """``b`` source, target and strong target images (normal noise
    shifted per sample), source labels in 3x3 blocks of the classes cut
    at rows and columns off the stride-8 grid, the golden traces' band of
    255 across the top of sample 0; with ``replay`` a clean target view
    and its metas (rotations 1, 3, 0, 2; vertical flips 1, 0, 0, 1;
    horizontal flips 0, 1, 0, 1)."""
    rs = np.random.RandomState(seed)
    shift = np.linspace(-2.0, 2.0, b).reshape(b, 1, 1, 1)

    def images():
        return (rs.randn(b, size, size, 3) + shift).astype(np.float32)

    gt = np.empty((b, size, size), np.int32)
    for i in range(b):
        rows = [0, *sorted(rs.choice(np.arange(16, size - 16, 8) + 3, 2,
                                     replace=False)), size]
        cols = [0, *sorted(rs.choice(np.arange(16, size - 16, 8) + 5, 2,
                                     replace=False)), size]
        for r in range(3):
            for c in range(3):
                gt[i, rows[r]:rows[r + 1], cols[c]:cols[c + 1]] = \
                    rs.randint(NUM_CLASSES)
    gt[0, :8] = 255
    batch = {'img': images(), 'gt_semantic_seg': gt, 'target_img': images(),
             'target_img_strong_aug': images()}
    if replay:
        batch['target_img_ori'] = images()
        batch.update(rotate_k=np.asarray([1, 3, 0, 2][:b], np.int32),
                     flip_vertical=np.asarray([1, 0, 0, 1][:b], np.int32),
                     flip_horizontal=np.asarray([0, 1, 0, 1][:b], np.int32))
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v) if v.ndim < 4 else nchw(v)
            for k, v in batch.items()}


def _to_jax(premix):
    def one(k, v):
        if isinstance(v, (tuple, list)):
            return tuple(one(k, x) for x in v)
        if v.ndim == 4:
            return jnp.asarray(nhwc(v))
        return jnp.asarray(v.numpy().astype(
            np.int32 if 'label' in k or 'lbl' in k else np.float32))
    return {k: one(k, v) for k, v in premix.items()}


@pytest.fixture(scope='module')
def weights():
    """Student, teacher and frozen-reference variables of the tiny model
    (numpy draws; the teacher and the reference perturbed from the
    student by two seeds)."""
    model = jax_train_model(_train_cfg(UDA_CFGS['PGST'])).model
    student = jax_variables(model, (1, HW, HW, 3), seed=0)
    out = [student]
    for seed in (1, 2):
        rs = np.random.RandomState(seed)
        out.append(jax.tree.map(
            lambda x: (x + 0.05 * rs.randn(*x.shape)).astype(np.float32),
            student))
    return out


def _jax_state(weights, fdist=False, tx=None, step=START_STEP):
    student, teacher, imnet = weights
    tx = tx or jax_opt.build_optimizer(SGD)
    return tx, jax_uda.UDATrainState(
        params=student['params'], batch_stats=student['batch_stats'],
        ema_params=teacher['params'], ema_batch_stats=teacher['batch_stats'],
        opt_state=jax.jit(tx.init)(student['params']),
        step=jnp.asarray(step, jnp.int32),
        imnet_params=imnet['params'] if fdist else {})


def _port(uda, jstate, tx=SGD):
    algo = build_train_model(_train_cfg(uda), device='cpu')
    state = algo.init_state(torch.Generator().manual_seed(0),
                            build_optimizer(tx))
    return algo, load_jax_train_state(jstate, state)


def _class_scores(rng, b=B):
    """The ClassMix scores the JAX step draws from ``rng``
    (``pfgst.py:203,240``, ``dacs_transforms.py:59,78``)."""
    k_mix = jax.random.split(rng, 6)[2]
    return torch.from_numpy(np.stack([
        np.asarray(jax.random.uniform(k, (NUM_CLASSES + 1,)))
        for k in jax.random.split(k_mix, b)]))


def _port_premix(algo, state, tbatch, rng):
    """The port's ``teacher_and_mix`` on its EMA-updated teacher (a copy),
    with the JAX draw's ClassMix scores; returns (premix, generator)."""
    gen = torch.Generator().manual_seed(0)
    draws = algo.sample_draws(gen, B)
    draws['class_scores'] = _class_scores(rng)
    updated = UDATrainState(student=state.student,
                            teacher=copy.deepcopy(state.teacher),
                            optimizer=None, step=state.step)
    premix = algo.teacher_and_mix(algo.ema_update(updated, ALPHA), tbatch,
                                  draws, MEAN, STD)
    return premix, gen


# --------------------------------- losses ----------------------------------
def _loss_inputs(seed=0, b=2, c=5, h=12, w=14, ch=8):
    """NHWC inputs at the logits' resolution (no upsampling ties), label
    and mix maps at twice it, three feature levels."""
    rs = np.random.RandomState(seed)
    gt = rs.randint(0, c, (b, 2 * h, 2 * w)).astype(np.int32)
    gt[0, :4] = 255
    return dict(
        logits_trg=(rs.randn(b, h, w, c) * 2).astype(np.float32),
        logits_ema=(rs.randn(b, h, w, c) * 2).astype(np.float32),
        gt_src=gt,
        x_ema=[rs.randn(b, h, w, ch).astype(np.float32) for _ in range(3)],
        x_src=[rs.randn(b, h, w, ch).astype(np.float32) for _ in range(3)],
        # mostly target, so that the eroded target mask keeps pixels
        mix_masks=(rs.rand(b, 2 * h, 2 * w) > 0.9).astype(np.int32),
        img_trg=rs.rand(b, 2 * h, 2 * w, 3).astype(np.float32))


PFST_KW = dict(top_k=3, dilation=2, kernel_size=3,
               weights=golden_pfst.V1_WEIGHTS, feat_level=2)
FS_KW = dict(top_k=2, dilation=1, kernel_size=3,
             weights=golden_fmda.FS_WEIGHTS, feat_level=1, apply_ignore=True)
LOSS_CASES = {
    'PFSTLoss': PFST_KW,
    'PFSTLossV2': dict(PFST_KW, tau_pos=0.6, tau_neg=0.3, border_margin=2),
    'AdaptiveFeatSimLoss': FS_KW,
    'AdaptiveFeatSimLossV2': FS_KW,
    'MultiScaleAdaptiveFeatSimLoss': dict(FS_KW, feat_level=(0, 2)),
    'FeatSimLoss': dict(top_k=2, dilation=2, kernel_size=3,
                        sigmas=[4.0, 5.0], weights=[[0.5, 0.3], [0.2, 0.7]]),
    'FeatSimLossV2': dict(top_k=2, dilation=1, kernel_size=3,
                          weights=[[0.5, 0.3], [0.2, 0.7]]),
}


def _loss_fns(name, kw, t):
    """(port, jax) functions of (maps or source features, target logits)
    -> the loss dict, and the gradient inputs' names."""
    if name.startswith('FeatSimLoss'):
        def port_losses(maps, logits):
            return build_loss(dict(type=name, **kw))(list(maps), logits)[0]

        def jax_losses(maps, logits):
            return jax_build_loss(dict(type=name, **kw))(list(maps),
                                                         logits)[0]
        return port_losses, jax_losses

    def port_losses(x_src, logits):
        tt = {k: ([nchw(a) for a in v] if isinstance(v, list) else
                  nchw(v) if v.ndim == 4 else torch.from_numpy(v))
              for k, v in t.items()}
        return build_loss(dict(type=name, **kw))(
            {**tt, 'x_src': list(x_src), 'logits_trg': logits})

    def jax_losses(x_src, logits):
        tj = {k: [jnp.asarray(a) for a in v] if isinstance(v, list) else
              jnp.asarray(v) for k, v in t.items()}
        return jax_build_loss(dict(type=name, **kw))(
            {**tj, 'x_src': list(x_src), 'logits_trg': logits})
    return port_losses, jax_losses


@pytest.mark.parametrize('name', sorted(LOSS_CASES))
def test_loss_and_gradients_match_jax(name):
    """Values and gradients with respect to the student's inputs (target
    logits and source features; for the list losses the maps and the
    logits), at both similarity types, the JAX side of both in one
    compiled program. FeatSimLossV2 takes given similarity maps, so it has
    no similarity type; V3 and V4 build as V2, as in JAX."""
    t = _loss_inputs()
    sims = ('cosine', 'gaussian') if name != 'FeatSimLossV2' else (None,)
    cases = []
    for sim_type in sims:
        kw = dict(LOSS_CASES[name])
        if sim_type is not None:
            kw['sim_type'] = sim_type
            if 'sigmas' not in kw:
                kw['sigma'] = 30.0 if sim_type == 'cosine' else 4.0
        cases.append(_loss_fns(name, kw, t))
    if name == 'FeatSimLossV2':
        maps = [np.random.RandomState(1).rand(2, 6 + 2 * i, 7 + 3 * i,
                                              9).astype(np.float32)
                for i in range(2)]
    else:
        maps = t['x_src'][:2] if name.startswith('FeatSimLoss') \
            else t['x_src']
    args = (tuple(maps), t['logits_trg'])

    ports, coefs = [], []
    for port_losses, _ in cases:
        port_args = (tuple(nchw(a).requires_grad_() for a in args[0]),
                     nchw(args[1]).requires_grad_())
        out = {n: v for n, v in port_losses(*port_args).items()
               if n.startswith('loss')}
        # a weighted sum, so that no term's gradient hides behind another's
        coef = {n: 1.0 + i for i, n in enumerate(sorted(out))}
        sum(coef[n] * out[n] for n in out).backward()
        ports.append((out, port_args))
        coefs.append(coef)

    def jax_all(maps, logits):
        outs = []
        for (_, jax_losses), coef in zip(cases, coefs):
            def total(maps, logits, jax_losses=jax_losses, coef=coef):
                ref = {n: v for n, v in jax_losses(maps, logits).items()
                       if n.startswith('loss')}
                return sum(coef[n] * ref[n] for n in coef), ref
            outs.append(jax.value_and_grad(total, argnums=(0, 1),
                                           has_aux=True)(maps, logits))
        return outs

    refs = run_jit(jax_all, tuple(jnp.asarray(a) for a in args[0]),
                   jnp.asarray(args[1]))
    for sim_type, (out, port_args), ((_, ref), ref_grads) in zip(
            sims, ports, refs):
        names = sorted(out)
        assert sorted(ref) == names and names, sim_type
        for n in names:
            np.testing.assert_allclose(out[n].item(), float(ref[n]),
                                       rtol=2e-4, atol=2e-6,
                                       err_msg=f'{sim_type} {n}')
        assert any(float(ref[n]) != 0.0 for n in names)
        pairs = list(zip(port_args[0], ref_grads[0]))
        pairs.append((port_args[1], ref_grads[1]))
        for i, (arg, want) in enumerate(pairs):
            want = np.asarray(want)
            got = np.zeros_like(want) if arg.grad is None else nhwc(arg.grad)
            np.testing.assert_allclose(
                got, want, rtol=0,
                atol=1e-5 * max(1.0, float(np.abs(want).max())),
                err_msg=f'{sim_type} gradient {i}')
        assert float(np.abs(np.asarray(ref_grads[1])).max()) > 0
    if name == 'AdaptiveFeatSimLossV2':
        for alias in ('AdaptiveFeatSimLossV3', 'AdaptiveFeatSimLossV4'):
            assert build_loss(dict(type=alias, **FS_KW)).use_trg_mask
    if name == 'PFSTLossV2':
        assert isinstance(build_loss(dict(type='PFSTLossV4', **PFST_KW)),
                          type(build_loss(dict(type=name, **PFST_KW))))


def test_losses_give_their_vis_entries_only_with_img_trg():
    t = _loss_inputs()
    tt = {k: ([nchw(a) for a in v] if isinstance(v, list) else
              nchw(v) if v.ndim == 4 else torch.from_numpy(v))
          for k, v in t.items()}
    for name, vis in (('PFSTLoss', 2), ('PFSTLossV2', 1),
                      ('AdaptiveFeatSimLossV2', 1)):
        out = build_loss(dict(type=name, **LOSS_CASES[name]))(tt)
        assert sum(k.startswith('vis|') for k in out) == vis, name
        out = build_loss(dict(type=name, **LOSS_CASES[name]))(
            {k: v for k, v in tt.items() if k != 'img_trg'})
        assert not any(k.startswith('vis|') for k in out), name


# --------------------------------- replay ----------------------------------
def test_transform_by_metas_matches_jax_for_every_rotation_and_flip():
    rs = np.random.RandomState(3)
    ks, fv, fh = (np.asarray(a, np.int32).reshape(-1) for a in np.meshgrid(
        range(4), range(2), range(2), indexing='ij'))
    x = rs.randn(len(ks), 6, 6, 3).astype(np.float32)
    metas = dict(rotate_k=ks, flip_vertical=fv, flip_horizontal=fh)
    want = np.asarray(run_jit(jax_replay.transform_by_metas, jnp.asarray(x),
                              metas))
    got = transform_by_metas(nchw(x), {k: torch.from_numpy(v)
                                       for k, v in metas.items()})
    np.testing.assert_array_equal(nhwc(got), want)
    for i in range(len(ks)):      # and sample by sample in torch
        one = torch.rot90(nchw(x[i:i + 1]), int(ks[i]), dims=(2, 3))
        one = one.flip(2) if fv[i] else one
        one = one.flip(3) if fh[i] else one
        assert torch.equal(got[i:i + 1], one)
    # the shape-changing stages and the 'flip' meta form
    y = rs.rand(2, 8, 8, 2).astype(np.float32)
    for metas in (dict(scale_factor=(2.0, 2.0, 2.0, 2.0),
                       crop_bbox=(0, 96, 8, 104), pad_shape=(128, 128, 3)),
                  dict(flip=True, flip_direction=['vertical', 'horizontal'],
                       rotate_k=2)):
        want = np.asarray(jax_replay.transform_by_metas(
            jnp.asarray(y), metas, scale=1 / 8.))
        got = nhwc(transform_by_metas(nchw(y), metas, scale=1 / 8.))
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


# ------------------------------ teacher_and_mix -----------------------------
MIX_NAMES = ('DACS', 'FMDA', 'PGSTTRG', 'PGSTMixFeat', 'PFSTV4')


def _ema_teacher(jstate):
    a = min(1.0 - 1.0 / (START_STEP + 1), ALPHA)
    return jax.tree.map(lambda e, p: a * np.asarray(e) + (1 - a) *
                        np.asarray(p), jstate.ema_params, jstate.params)


@pytest.fixture(scope='module')
def jax_premix(weights):
    """JAX's ``teacher_and_mix`` of each name of ``MIX_NAMES`` on the same
    EMA-updated teacher and batch 11 (PFSTV4's with the clean view and its
    metas), all in one compiled program. The teacher forward on the plain
    target view is shared (the four take it as ``teacher_out``; DACS's
    ``teacher_forward`` is theirs, the same model and features)."""
    algos = {n: jax_train_model(_train_cfg(UDA_CFGS[n])) for n in MIX_NAMES}
    batches = {n: _batch(11, replay=n == 'PFSTV4') for n in MIX_NAMES}
    _, jstate = _jax_state(weights)
    mean, std = jnp.asarray(MEAN), jnp.asarray(STD)

    def all_premix(e, eb, batches, rng):
        # one teacher forward on the plain view for the first four; PFSTV4
        # runs its own on the clean view
        plain = algos['DACS'].teacher_forward(e, eb,
                                              batches['DACS']['target_img'])
        return {n: algos[n].teacher_and_mix(
            e, eb, batches[n], rng, mean, std,
            teacher_out=None if n == 'PFSTV4' else plain)
            for n in MIX_NAMES}

    with two_pass_batch_variance():
        return run_jit(all_premix, _ema_teacher(jstate),
                       jstate.ema_batch_stats, batches, jax.random.PRNGKey(7))


@pytest.mark.parametrize('name', MIX_NAMES)
def test_teacher_and_mix_matches_jax(weights, jax_premix, name):
    """The gradient-free half on the same EMA-updated teacher: DACS's
    ClassMix of the plain view, FMDA's and PGSTTRG's self-training views,
    PGSTMixFeat's weak mix and PFSTV4's replayed teacher outputs."""
    uda = UDA_CFGS[name]
    batch = _batch(11, replay=name == 'PFSTV4')
    rng = jax.random.PRNGKey(7)
    _, jstate = _jax_state(weights, fdist=name == 'DACS')
    ref = jax_premix[name]
    algo, state = _port(uda, jstate)
    premix = _port_premix(algo, state, _torch_batch(batch), rng)[0]
    assert sorted(premix) == sorted(ref)
    np.testing.assert_array_equal(premix['mix_masks'].numpy(),
                                  np.asarray(ref['mix_masks']))
    if name in ('FMDA', 'PGSTTRG'):
        assert not premix['mix_masks'].any()
    else:
        assert 0 < float(premix['mix_masks'].mean()) < 1
    np.testing.assert_allclose(nhwc(premix['ema_logits']),
                               ref['ema_logits'], **TOL)
    for got, want in zip(premix['ema_feats'], ref['ema_feats'], strict=True):
        np.testing.assert_allclose(nhwc(got), want, **TOL)
    for k in ('mixed_img', 'mixed_img_weak'):
        if k in ref:
            np.testing.assert_allclose(nhwc(premix[k]), ref[k], atol=1e-6,
                                       rtol=0, err_msg=k)
    # 'all' weighs by the share of confident pixels: a pixel whose
    # confidence sits within 1e-4 of the threshold may count on one side
    # only, as the argmax near-ties below
    conf = torch.softmax(premix['ema_logits'], dim=1).amax(dim=1)
    near = float(((conf - TAU).abs() < 1e-4).float().mean())
    np.testing.assert_allclose(premix['pseudo_weight'].numpy(),
                               ref['pseudo_weight'], atol=1e-6 + near)
    for k in ('pseudo_label', 'mixed_lbl'):
        assert (premix[k].numpy() == np.asarray(ref[k])).mean() > 0.999, k
    if name == 'PFSTV4':
        # the replay moved the teacher's outputs: sample 0 is rotated
        raw = algo.teacher_forward(state, nchw(batch['target_img_ori']))[0]
        assert not torch.allclose(raw, premix['ema_logits'])


# -------------------------------- one step ---------------------------------
def _step_case(weights, uda):
    _, jstate = _jax_state(weights, fdist=uda['type'] == 'DACS')
    batch = _batch(5)
    rng = jax.random.PRNGKey(7)
    algo, state = _port(uda, jstate)
    premix, gen = _port_premix(algo, state, _torch_batch(batch), rng)
    return jstate, batch, rng, algo, state, premix, gen


@pytest.mark.parametrize('name', ['PGST', 'PGSTMixFeat', 'FMDA', 'PFST',
                                  'DACS'])
def test_step_matches_jax(weights, name):
    """One SGD step of the port against the JAX step given the port's
    premix: log vars, EMA, BN statistics and post-step parameters (and
    DACS's frozen reference untouched on both sides)."""
    uda = UDA_CFGS[name]
    jstate, batch, rng, algo, state, premix, gen = _step_case(weights, uda)
    algo_j = jax_train_model(_train_cfg(uda))
    step_fn = algo_j.make_train_step(jax_opt.build_optimizer(SGD), MEAN,
                                     STD, jit=False)
    jpremix = _to_jax(premix)
    with two_pass_batch_variance():
        new_state, log_vars, _ = jax.jit(
            lambda s, b, r, p: step_fn(s, b, r, premix=p)).lower(
                jstate, batch, rng, jpremix).compile(FAST_COMPILE)(
                    jstate, batch, rng, jpremix)
    counts = {}
    hooks = [m.register_forward_hook(
        lambda mod, inp, out, name=n: counts.__setitem__(
            name, inp[0].numel() // inp[0].shape[1]))
        for n, m in state.student.named_modules()
        if isinstance(m, torch.nn.BatchNorm2d)]
    imnet0 = copy.deepcopy(state.imnet.state_dict()) if state.imnet else None
    state, got = algo.make_train_step(MEAN, STD)(
        state, _torch_batch(batch), gen, premix=premix)
    for h in hooks:
        h.remove()
    assert state.step == int(new_state.step) == START_STEP + 1
    assert sorted(got) == sorted(log_vars)
    for k in log_vars:
        # grad_mag is a norm of gradients, held as the gradients are (the
        # post-step parameters below): with train-mode BN after every
        # conv, fp32 gets the backbone's gradient norm to ~1e-3 of an fp64
        # evaluation on either side (here the port's 9.6e-4, JAX's 4.3e-4)
        tol = dict(rtol=1e-3, atol=0) if k == 'grad_mag' else \
            dict(rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(got[k].item(), float(log_vars[k]),
                                   err_msg=k, **tol)
    if name == 'FMDA':
        assert any(k.startswith('trg.') for k in got)
    elif name == 'DACS':
        assert {'grad_mag', 'loss_imnet_feat_dist'} <= set(got)
        assert float(log_vars['loss_imnet_feat_dist']) > 0
        # by its definition: the global norm of the backbone's gradients,
        # which stay on the parameters after the step
        grads = torch.cat([p.grad.flatten() for p in
                           state.student.backbone.parameters()])
        np.testing.assert_allclose(got['grad_mag'].item(),
                                   float(grads.double().norm()), rtol=1e-6)
        for k, v in state.imnet.state_dict().items():
            assert torch.equal(v, imnet0[k]), k
        _assert_trees_close(_tree(state.imnet)[0], new_state.imnet_params,
                            'imnet', rtol=0, atol=0)
    else:
        assert float(log_vars['loss_sim_pos']) != 0.0
    _assert_trees_close(_tree(state.teacher)[0], new_state.ema_params,
                        'EMA', rtol=1e-5, atol=1e-6)
    _assert_bn_stats_close(state.student, jstate, new_state, counts)
    _assert_trees_close(_tree(state.student)[0], new_state.params,
                        'post-step student', rtol=1e-3, atol=3e-5)


def test_pgst_blend_at_full_resolution_matches_jax():
    """PGST's blend of the student's source map and the teacher's at
    ``feat_level``, as JAX's step composes it (``pfgst.py:460-472``): both
    nearest-upsampled to the masks' full resolution with the JAX
    package's ``resize`` and mixed there, then the aux loss's nearest
    resize to the logits (stride 4) reads it back down; the other levels
    dropped. Label edges off the feature stride make a blend at feature
    resolution differ."""
    from pfst_tpu.ops import resize as jax_resize
    rs = np.random.RandomState(4)
    src = rs.randn(2, 16, 16, 5).astype(np.float32)      # stride 8 of 128
    ema = rs.randn(2, 16, 16, 5).astype(np.float32)
    masks = (_batch(5, b=2)['gt_semantic_seg'] % 2).astype(np.float32)
    m = jnp.asarray(masks)[..., None]
    want = m * jax_resize(jnp.asarray(src), size=(128, 128),
                          mode='nearest') + (1.0 - m) * jax_resize(
        jnp.asarray(ema), size=(128, 128), mode='nearest')
    algo = build_train_model(_train_cfg(UDA_CFGS['PGST']), device='cpu')
    lvl = algo.mix_ema_feat_level
    feats = tuple(nchw(src) if i == lvl else None for i in range(lvl + 1))
    got = algo.mix_ema_feats(feats, tuple(
        nchw(ema) if i == lvl else None for i in range(lvl + 1)),
        torch.from_numpy(masks))
    assert all(f is None for f in got[:lvl]) and len(got) == lvl + 1
    np.testing.assert_array_equal(nhwc(got[lvl]), np.asarray(want))
    down = nhwc(resize(got[lvl], size=(32, 32), mode='nearest'))
    at_feature_res = nhwc(resize(
        torch.from_numpy(masks)[:, None], size=(16, 16), mode='nearest')
        * nchw(src) + (1.0 - resize(torch.from_numpy(masks)[:, None],
                                    size=(16, 16), mode='nearest'))
        * nchw(ema))
    assert not np.array_equal(down, nhwc(resize(
        nchw(at_feature_res), size=(32, 32), mode='nearest')))


@pytest.mark.parametrize('name,shares', [
    ('PFSTV2', 'PFST'), ('PFSTV3', 'PFST'), ('PFSTV4', 'PFST'),
    ('PGSTV4', 'PFGST'), ('FMDAMix', 'PGST'), ('PGSTTRG', 'FMDA')])
def test_other_names_take_the_step_they_share(weights, name, shares):
    """Each other registered name builds and, given the same state, batch
    and premix (the shared composition's), takes the step of the
    composition it shares, its config with the shared ``type``: PFST's for
    V2-V4, PFGST's on backbone maps for PGSTV4 (no blend), PGST's blend for
    FMDAMix, FMDA's ``trg`` step for PGSTTRG."""
    shared = dict(UDA_CFGS[name], type=shares)
    jstate, batch, _, _, _, premix, _ = _step_case(weights, shared)
    results = []
    for cfg in (UDA_CFGS[name], shared):
        algo, state = _port(cfg, jstate)
        results.append(algo.make_train_step(MEAN, STD)(
            state, _torch_batch(batch), torch.Generator().manual_seed(3),
            premix=premix)[1])
    assert sorted(results[0]) == sorted(results[1])
    for k in results[0]:
        assert torch.equal(results[0][k], results[1][k]), k
    if name == 'PGSTTRG':
        assert any(k.startswith('trg.') for k in results[0])


def test_checkpoint_keeps_the_frozen_reference(tmp_path):
    """With the feature distance on, a checkpoint saves the frozen
    reference as ``imnet_model.*`` and a resume restores it exactly;
    ``load_from`` refreshes the teacher and the reference from the loaded
    student, as the JAX loop does (``apis/train.py:285-316``)."""
    algo = build_train_model(_train_cfg(UDA_CFGS['DACS']), device='cpu')

    def fresh(seed):
        return algo.init_state(torch.Generator().manual_seed(seed),
                               build_optimizer(SGD))

    state = fresh(0)
    with torch.no_grad():
        for p in state.imnet.parameters():
            p.add_(0.5)
    path = save_checkpoint(str(tmp_path), 3, state)
    saved = load_checkpoint(path)
    assert any(k.startswith('imnet_model.') for k in saved['state_dict'])
    restored = restore_state(fresh(1), saved)
    for k, v in state.imnet.state_dict().items():
        assert torch.equal(restored.imnet.state_dict()[k], v), k
    warm = load_weights_into_state(fresh(1), saved)
    want = state.student.state_dict()
    for module in (warm.student, warm.teacher, warm.imnet):
        for k, v in module.state_dict().items():
            assert torch.equal(v, want[k]), k


# --------------------------------- data ------------------------------------
def _ori_pipeline(pipeline, collect_replay=True):
    """``pipeline`` with ``KeepOriImage`` after ``RandomCrop`` and the
    snapshot and its metas collected."""
    out = copy.deepcopy(pipeline)
    if not any(t['type'] == 'KeepOriImage' for t in out):
        i = next(i for i, t in enumerate(out) if t['type'] == 'RandomCrop')
        out.insert(i + 1, dict(type='KeepOriImage'))
    if collect_replay:
        keys = out[-1]['keys']
        out[-1]['keys'] = keys + [k for k in ('ori_img',) + REPLAY_KEYS
                                  if k not in keys]
    return out


def _uda_dataset_cfg(root, jax_side):
    """Source pipeline with a snapshot and its metas of its own (so that a
    merge that keeps the source's metas shows), the JAX test's replay
    target pipeline; JAX's ``Resize`` draws its ratio as the port's does
    (``override_scale``, ROADMAP C2)."""
    cfg = dict(type='UDADataset',
               source=_source_cfg(root, _ori_pipeline(SOURCE_PIPELINE)),
               target=_source_cfg(root, _ori_pipeline(ORI_TARGET_PIPELINE)),
               rare_class_sampling=None)
    if jax_side:
        for part in ('source', 'target'):
            for t in cfg[part]['pipeline']:
                if t['type'] == 'Resize':
                    t['override_scale'] = True
    return cfg


def test_keep_ori_image_and_merge_match_jax(isprs_root, monkeypatch):
    """``KeepOriImage``, ``Pad`` / ``Normalize`` of the snapshot, the
    bundle's metas and ``UDADataset._merge`` give the JAX package's samples
    exactly on the same files and ``np.random`` seed (images CHW here); the
    merged metas are the target's. The source crops can be narrower than
    32 pixels, where the JAX package's HSV must take the port's kernel
    (``PFST_NATIVE_HSV=1``, ROADMAP C2)."""
    monkeypatch.setenv('PFST_NATIVE_HSV', '1')
    port = build_dataset(_uda_dataset_cfg(isprs_root, False))
    ref = jax_build_dataset(_uda_dataset_cfg(isprs_root, True))
    assert len(port) == len(ref) == 16
    differs = 0
    for idx in (0, 5, 10, 15):
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
                assert got[k].dtype == v.dtype
                assert np.array_equal(got[k], v.transpose(2, 0, 1)), k
            else:
                assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
        np.random.seed(idx)
        source = port.source[idx // len(port.target)]
        differs += any(int(source[k]) != int(got[k]) for k in REPLAY_KEYS)
        assert 'target_img_ori' in got
    assert differs, 'no sample tells the target metas from the source ones'


def test_keep_ori_image_replay_invariant(isprs_root):
    """The clean snapshot, replayed by its metas, is the augmented target
    view (geometry only: the replay target pipeline has no photometric
    step on ``img``), through the port's loader."""
    cfg = dict(type='UDADataset',
               source=_source_cfg(isprs_root, SOURCE_PIPELINE),
               target=_source_cfg(isprs_root, ORI_TARGET_PIPELINE),
               rare_class_sampling=None)
    np.random.seed(0)
    loader = DataLoader(build_dataset(cfg), samples_per_gpu=2,
                        workers_per_gpu=1, seed=0)
    try:
        b = next(iter(loader))
    finally:
        loader.close()
    assert b['target_img_ori'].shape == b['target_img'].shape
    assert b['rotate_k'].shape == (2,) and b['rotate_k'].dtype == torch.int32
    out = transform_by_metas(b['target_img_ori'],
                             {k: b[k] for k in REPLAY_KEYS})
    assert torch.equal(out, b['target_img'])


# ------------------------------- trajectory --------------------------------
def test_pfgst_trajectory_true_regime(weights):
    """ROADMAP A6: 12 PFGST steps at the ``adamw_40k`` values (lr 6e-5,
    eps 1e-8, linear warmup 1500 from 1e-6 over 40000 iterations), the JAX
    side run as ``tests/test_uda_trajectory.py::
    test_pfgst_trajectory_true_regime`` runs it and the port in the torch
    twin's place. Fresh batches each step; the ClassMix scores of step i
    come from the JAX step's ``fold_in(rng, i)``. Every log var at every
    step within that test's bounds (accuracies 2.0 points, the rest rtol
    and atol 4e-3); the optax count and the port's schedule at every step;
    every 2 steps the parameters, EMA and BN statistics within 0.75 of the
    segment's motion plus its floor (``artifacts/
    trajectory_noise_floor_r5.json``), then the JAX state re-synced from
    the port while both optimizers' moments flow on."""
    size, lr, warmup, ratio, max_iters = 64, 6e-5, 1500, 1e-6, 40000
    uda = pfgst_uda_cfg('all')
    opt_cfg = dict(type='AdamW', lr=lr, betas=BETAS, weight_decay=WD,
                   eps=1e-8)
    lr_cfg = dict(policy='poly', warmup='linear', warmup_iters=warmup,
                  warmup_ratio=ratio, power=1.0, min_lr=0.0)
    algo_j = jax_train_model(_train_cfg(uda, max_iters))
    tx = jax_opt.build_optimizer(opt_cfg, lr_config=lr_cfg,
                                 max_iters=max_iters)
    _, state_j = _jax_state(weights, tx=tx, step=0)
    algo = build_train_model(_train_cfg(uda, max_iters), device='cpu')
    state = load_jax_train_state(state_j, algo.init_state(
        torch.Generator().manual_seed(0),
        build_optimizer(opt_cfg, lr_cfg, max_iters)))
    step_j = algo_j.make_train_step(tx, MEAN, STD, jit=False)
    batches = [_batch(100 + i, size) for i in range(N_STEPS)]
    with two_pass_batch_variance():
        step_j = jax.jit(step_j).lower(state_j, batches[0], jax.random.PRNGKey(
            0)).compile(FAST_COMPILE)
    step = algo.make_train_step(MEAN, STD)
    draws_fn = algo.sample_draws
    base_rng = jax.random.PRNGKey(31)

    def flat(tree):
        return {jax.tree_util.keystr(p): np.array(v) for p, v in
                jax.tree_util.tree_leaves_with_path(tree)}

    seg = None
    for i in range(N_STEPS):
        rng = jax.random.fold_in(base_rng, i)
        scores = _class_scores(rng)
        algo.sample_draws = lambda g, b, s=scores: dict(draws_fn(g, b),
                                                        class_scores=s)
        if seg is None:
            seg = [flat(state_j.params), flat(state_j.ema_params),
                   flat(state_j.batch_stats)]
        state_j, ref, _ = step_j(state_j, batches[i], rng)
        counts = [int(v) for p, v in
                  jax.tree_util.tree_leaves_with_path(state_j.opt_state)
                  if 'count' in jax.tree_util.keystr(p)]
        assert counts and all(c == i + 1 for c in counts), (i, counts)
        np.testing.assert_allclose(state.optimizer.lr,
                                   mmcv_poly_warmup_lr(
                                       i, lr, warmup, ratio, max_iters),
                                   rtol=1e-6)
        state, got = step(state, _torch_batch(batches[i]),
                          torch.Generator().manual_seed(i))
        assert sorted(got) == sorted(ref), i
        for k in ref:
            tol = dict(rtol=0, atol=2.0) if k.endswith('acc_seg') else \
                dict(rtol=4e-3, atol=4e-3)
            np.testing.assert_allclose(got[k].item(), float(ref[k]),
                                       err_msg=f'step {i} {k}', **tol)
        if (i + 1) % 2:
            continue
        ps, bs = _tree(state.student)
        pt, _ = _tree(state.teacher)
        for got_t, want_t, init, floor, what in (
                (state_j.params, ps, seg[0], 5e-4, 'student'),
                (state_j.ema_params, pt, seg[1], 5e-4, 'EMA'),
                (state_j.batch_stats, bs, seg[2], 2e-3, 'BN')):
            want = flat(_merge(got_t, want_t))
            for key, leaf in flat(got_t).items():
                drift = float(np.max(np.abs(leaf - want[key])))
                motion = float(np.max(np.abs(want[key] - init[key])))
                assert drift <= 0.75 * motion + floor, (
                    f'step {i} {what} {key}: drift {drift:.2e} > 0.75 * '
                    f'{motion:.2e} + {floor:.0e}')
        state_j = state_j.replace(
            params=_merge(state_j.params, ps),
            batch_stats=_merge(state_j.batch_stats, bs),
            ema_params=_merge(state_j.ema_params, pt))
        seg = None
    assert state.step == int(state_j.step) == N_STEPS
