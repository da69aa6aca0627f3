"""The port's cascade (OCRNet, PointRend), K-Net and STDC with their
training branches, ``point_sample``, the OHEM pixel sampler, the Dice,
focal and Lovasz losses and the ResNet's ``with_cp`` and ``s2d_stem``
against the JAX package on the CPU.

The defs at narrow widths on 64^2 inputs: the ResNets at depth 18 with 8
stem and base channels (OCRNet's and K-Net's at output stride 8, 8^2
features; PointRend's FPN 16 wide at 16^2, 8^2, 4^2, 2^2), heads at 16
channels and 5 classes, no dropout; OCR's ``ocr_channels`` 8; PointRend's
``num_points`` 48 (of 16^2 = 256 positions), 3 x oversampled; K-Net's
three stages at 16 channels, 2 heads, a 32-wide FFN, the updator 8 wide
(and the same with 3 x 3 kernels); STDC's net at (8, 16, 32, 64, 128)
with a 16-wide context path, its OHEM heads at ``min_kept`` 1000.
Weights come from ``torch_parity.jax_variables`` through
``jax_variables_to_state_dict``, which must fill every key. One JAX
program a def computes the backbone's taps, the neck's outputs, each
stage's (or K-Net stage's) logits, the decoded features, the auxiliary
logits and the segmentor's logits, shared by the tests and across
xdist's workers through ``torch_parity.shared_by_workers``; each head is
held on the JAX program's own inputs to it, each segmentor on the image.
The point loss's two uniform draws are the test's on both sides: the
JAX side's ``jax.random.uniform`` returns them (pytest's
``monkeypatch``), the port takes them as ``draws``.

At the configs' full widths, the port's state dict (built on the meta
device) is held key for key to the JAX tree's shapes (``jax.eval_shape``
of ``init``; nothing compiles); every JAX leaf has a key and no two keys
share a leaf.

Tolerances: ``test_torch_context_heads.py``'s. Forward atol 1e-4, rtol
1e-4 (fp32 in another order); the step's log vars rtol 2e-4, atol 2e-5,
post-step parameters rtol 1e-3, atol 3e-5, BN statistics rtol 2e-3, atol
2e-4 after the n/(n-1) gap of ROADMAP C2. The losses and their gradients
within 1e-5 (relative and absolute) of the JAX functions'.
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

from torch_parity import (FAST_COMPILE, jax_variables, load_port,  # noqa: E402
                          nchw, nhwc, run_jit, shared_by_workers,
                          two_pass_batch_variance)

from pfst_tpu.apis.train import SupervisedTrainer as JaxTrainer  # noqa: E402
from pfst_tpu.core import optimizers as jax_opt  # noqa: E402
from pfst_tpu.core.seg import OHEMPixelSampler as JaxOHEM  # noqa: E402
from pfst_tpu.models import build_backbone as jax_backbone  # noqa: E402
from pfst_tpu.models import build_head as jax_build_head  # noqa: E402
from pfst_tpu.models import build_loss as jax_build_loss  # noqa: E402
from pfst_tpu.models import build_segmentor as jax_segmentor  # noqa: E402
from pfst_tpu.models.uda.uda_decorator import UDATrainState  # noqa: E402
from pfst_tpu.ops import resize as jax_resize  # noqa: E402
from pfst_tpu.ops.point_sample import \
    point_sample as jax_point_sample  # noqa: E402
from pfst_tpu_torch.apis import build_algorithm  # noqa: E402
from pfst_tpu_torch.core import (build_optimizer,  # noqa: E402
                                 jax_variables_to_state_dict, param_paths)
from pfst_tpu_torch.core.convert import (key_families,  # noqa: E402
                                         torch_key_to_flax)
from pfst_tpu_torch.core.seg import OHEMPixelSampler  # noqa: E402
from pfst_tpu_torch.models import (build_backbone, build_head,  # noqa: E402
                                   build_loss, build_segmentor)
from pfst_tpu_torch.models.decode_heads.point_rend import \
    PointRendHead  # noqa: E402
from pfst_tpu_torch.ops import point_sample, resize  # noqa: E402
from pfst_tpu_torch.utils import Config  # noqa: E402

CONFIGS = osp.join(osp.dirname(__file__), '..', 'configs', '_base_',
                   'models')
TOL = dict(atol=1e-4, rtol=1e-4)
LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
SGD = dict(type='SGD', lr=1e-2)
SIZE = 64
R18 = dict(depth=18, base_channels=8, stem_channels=8)
NORM = dict(type='BN', requires_grad=True)
FULL_DEFS = ['ocrnet_hr18', 'ocrnet_r50-d8', 'pointrend_r50', 'knet_s3_fcn',
             'stdc']
DEFS = ['ocrnet_r50-d8', 'pointrend_r50', 'knet_s3_fcn', 'knet_k3', 'stdc']


def _head(cfg, **kw):
    cfg.update(kw, dropout_ratio=0.0, num_classes=5)
    return cfg


def _knet(cfg, k):
    dh = cfg['decode_head']
    _head(dh['kernel_generate_head'], in_channels=64, channels=16)
    dh['num_classes'] = 5
    for upd in dh['kernel_update_head']:
        upd.update(num_classes=5, num_heads=2, feedforward_channels=32,
                   in_channels=16, out_channels=16, conv_kernel_size=k)
        upd['kernel_updator_cfg'].update(in_channels=16, feat_channels=8,
                                         out_channels=16)


def tiny_cfg(name):
    """A def at narrow widths (module docstring); ``knet_k3`` is K-Net
    with 3 x 3 kernels."""
    base = 'knet_s3_fcn' if name == 'knet_k3' else name
    cfg = Config.fromfile(osp.join(CONFIGS, f'{base}.py')).to_dict()['model']
    if name == 'stdc':
        cfg['backbone']['backbone_cfg']['channels'] = (8, 16, 32, 64, 128)
        cfg['backbone'].update(last_in_channels=(128, 64), out_channels=16,
                               ffm_cfg=dict(in_channels=48, out_channels=32,
                                            scale_factor=4))
        _head(cfg['decode_head'], in_channels=32, channels=16)
        for aux in cfg['auxiliary_head']:
            _head(aux, in_channels=16, channels=8)
        cfg['auxiliary_head'][2].update(in_channels=32, num_classes=2)
        for h in [cfg['decode_head'], *cfg['auxiliary_head'][:2]]:
            h['sampler']['min_kept'] = 1000
        return cfg
    cfg['backbone'].update(R18)
    if name.startswith('knet'):
        _knet(cfg, 3 if name == 'knet_k3' else 1)
        _head(cfg['auxiliary_head'], in_channels=32, channels=8)
    elif name == 'ocrnet_r50-d8':
        _head(cfg['decode_head'][0], in_channels=32, channels=16)
        _head(cfg['decode_head'][1], in_channels=64, channels=16,
              ocr_channels=8)
    elif name == 'pointrend_r50':
        cfg['neck'].update(in_channels=(8, 16, 32, 64), out_channels=16)
        _head(cfg['decode_head'][0], in_channels=(16,) * 4, channels=16)
        _head(cfg['decode_head'][1], in_channels=(16,), channels=16,
              num_points=48)
    return cfg


def _images(rs, b, size=SIZE):
    """Normal noise, each image shifted by its own offset (train-mode BN
    of a pooled branch normalizes one value per image)."""
    shift = np.linspace(-2.0, 2.0, b).reshape(b, 1, 1, 1)
    return (rs.randn(b, size, size, 3) + shift).astype(np.float32)


def _knet_stage(module, method):
    return method == '__call__' and (module.name or '').startswith(
        ('kgh', 'update_head'))


def _jax_reference(name):
    """The JAX model's variables, and on two seeded images its backbone
    taps, features, stage logits (K-Net's stages), decoded features,
    auxiliary logits and the segmentor's logits (its last stage's
    resized, as ``encode_decode`` resizes them; numpy)."""
    jmodel = jax_segmentor(copy.deepcopy(tiny_cfg(name)))
    variables = jax_variables(jmodel, (1, SIZE, SIZE, 3))
    img = _images(np.random.RandomState(4), 2)

    def run(v, x):
        out, inter = jmodel.apply(v, x, capture_intermediates=_knet_stage,
                                  mutable=['intermediates'])
        taps = out['feats']
        if jmodel.neck:
            taps = jmodel.apply(v, x, method=lambda m, t: m.backbone_mod(t))
        stages = out.get('stage_logits')
        if name.startswith('knet'):
            heads = inter['intermediates']['decode_head_mod']
            stages = [heads['kgh']['__call__'][0][0]] + [
                heads[f'update_head{i}']['__call__'][0][0] for i in range(3)]
        logits = jax_resize(out['seg_logits'], size=x.shape[1:3],
                            mode='bilinear',
                            align_corners=jmodel.align_corners)
        return dict(taps=taps, feats=out['feats'], stages=stages,
                    decoded=out['decoded_features'],
                    aux_logits=out['aux_logits'], logits=logits)

    out = run_jit(run, variables, img)
    return dict(variables=jax.tree.map(np.asarray, variables), img=img,
                out=jax.tree.map(np.asarray, out))


@pytest.fixture(scope='module')
def refs(tmp_path_factory):
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = shared_by_workers(
                tmp_path_factory, f'cascade_knet_stdc_{name}',
                lambda: _jax_reference(name))
        return cache[name]
    return get


def _port(name, variables):
    return load_port(build_segmentor(tiny_cfg(name)), variables)


def _close(got, want, tol=TOL):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(nhwc(g), w, **tol)


# -------------------------------- the ops --------------------------------
def _coords(rs, b, n):
    """Uniform points over [-0.2, 1.2]^2 (outside the image too), the
    image's corners, and points on the 8-pixel grid's half-pixel lines
    ((i + 1) / 8: rounding half to even)."""
    pts = rs.uniform(-0.2, 1.2, (b, n, 2))
    pts[:, :4] = [[0, 0], [1, 1], [0, 1], [1, 0]]
    pts[:, 4:12, 0] = np.arange(1, 9) / 8.0
    pts[:, 4:12, 1] = np.arange(8, 0, -1) / 8.0
    return pts.astype(np.float32)


@pytest.mark.parametrize('mode', ['bilinear', 'nearest'])
@pytest.mark.parametrize('align_corners', [False, True])
def test_point_sample_matches_jax(mode, align_corners):
    """``point_sample`` on a 6 x 8 map at 40 points, at the border, on
    the half-pixel lines and outside the image: within 1e-6 of the JAX
    function (nearest exactly)."""
    rs = np.random.RandomState(0)
    feat = rs.randn(2, 6, 8, 3).astype(np.float32)
    coords = _coords(rs, 2, 40)
    want = np.asarray(run_jit(lambda f, c: jax_point_sample(
        f, c, mode, align_corners), feat, coords))
    got = point_sample(nchw(feat), torch.from_numpy(coords), mode,
                       align_corners)
    assert got.shape == (2, 40, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6,
                               rtol=0 if mode == 'nearest' else 1e-6)


def _trained_logits(rs, gt, c):
    """Logits a trained net might give: the label's class ahead by 0-6,
    so the gt probabilities spread over (0, 1)."""
    logits = rs.randn(*gt.shape, c)
    safe = np.where(gt == 255, 0, gt)
    np.put_along_axis(logits, safe[..., None], rs.uniform(0.0, 6.0,
                                                          gt.shape + (1,)),
                      axis=-1)
    return logits.astype(np.float32)


@pytest.mark.parametrize('thresh', [0.7, None])
@pytest.mark.parametrize('min_kept', [50, 500])
def test_ohem_sampler_matches_jax(thresh, min_kept):
    """``OHEMPixelSampler`` on trained-looking logits of 2 x 16^2 pixels,
    the first image with 60 ignored, the second with all but 100: with 50
    kept the threshold (or the loss cut) is a valid pixel's; with 500,
    more than the second image's valid pixels, the kept index is clamped
    into them. Equal to the JAX sampler's weights."""
    rs = np.random.RandomState(1)
    gt = rs.randint(0, 5, (2, 16, 16))
    gt.reshape(2, -1)[0, rs.permutation(256)[:60]] = 255
    gt.reshape(2, -1)[1, rs.permutation(256)[:156]] = 255
    logits = _trained_logits(rs, gt, 5)
    want = np.asarray(run_jit(JaxOHEM(thresh=thresh,
                                      min_kept=min_kept).sample, logits, gt))
    got = OHEMPixelSampler(thresh=thresh, min_kept=min_kept).sample(
        nchw(logits), torch.from_numpy(gt))
    if thresh is not None:
        # the threshold decides: neither all nor none of the valid pixels
        assert 0 < want[gt != 255].mean() < 1
    np.testing.assert_array_equal(got.numpy(), want)


LOSS_CASES = [
    ('dice', dict(type='DiceLoss'), {}),
    ('dice_cw', dict(type='DiceLoss', smooth=2.0, exponent=3,
                     class_weight=[0.5, 1.0, 1.5, 0.7, 1.3]), {}),
    ('focal', dict(type='FocalLoss'), {}),
    ('focal_weighted', dict(type='FocalLoss', gamma=3.0, alpha=0.25,
                            class_weight=[1.0, 0.5, 2.0, 0.8, 1.2]),
     dict(weight=True)),
    ('lovasz', dict(type='LovaszLoss'), {}),
    ('lovasz_per_image', dict(type='LovaszLoss', per_image=True), {}),
    ('lovasz_all', dict(type='LovaszLoss', classes='all',
                        class_weight=[1.0, 0.5, 2.0, 0.8, 1.2]), {}),
    ('lovasz_all_per_image', dict(type='LovaszLoss', classes='all',
                                  per_image=True), {})]


def _loss_data(seed, c=5):
    rs = np.random.RandomState(seed)
    logits = (2.0 * rs.randn(2, 9, 7, c)).astype(np.float32)
    gt = rs.randint(0, c - 1, (2, 9, 7))     # class c - 1 absent
    gt[0, :2] = 255
    weight = rs.uniform(0.0, 1.0, gt.shape).astype(np.float32)
    return logits, gt, weight


@pytest.mark.parametrize('case, cfg, extra', LOSS_CASES,
                         ids=[c[0] for c in LOSS_CASES])
def test_loss_and_gradient_match_jax(case, cfg, extra):
    """Each loss and its gradient with respect to the logits on 2 x 9 x
    7 pixels of 5 classes, one absent and two rows ignored, within 1e-5
    of the JAX loss's (``jax.grad``)."""
    logits, gt, weight = _loss_data(2)
    kw = dict(ignore_index=255)
    jloss = jax_build_loss(dict(cfg))
    jw = weight if extra.get('weight') else None
    want, want_grad = run_jit(jax.value_and_grad(
        lambda x, g, w: jloss(x, g, weight=w, **kw)), logits, gt, jw)
    x = nchw(logits).requires_grad_()
    loss = build_loss(dict(cfg))
    got = loss(x, torch.from_numpy(gt), weight=None if jw is None else
               torch.from_numpy(weight), **kw)
    got.backward()
    assert loss.loss_name == jloss.loss_name
    np.testing.assert_allclose(got.item(), float(want), **LOSS_TOL)
    np.testing.assert_allclose(nhwc(x.grad), np.asarray(want_grad),
                               **LOSS_TOL)


@pytest.mark.parametrize('per_image', [False, True])
def test_lovasz_at_tied_errors_matches_jax(per_image):
    """Equal logits make every pixel's error of a class one of two
    values: the sort's order among ties is free, the loss is not."""
    _, gt, _ = _loss_data(3)
    logits = np.zeros(gt.shape + (5,), np.float32)
    cfg = dict(type='LovaszLoss', per_image=per_image)
    want = float(run_jit(jax_build_loss(dict(cfg)), logits, gt))
    got = build_loss(dict(cfg))(nchw(logits), torch.from_numpy(gt))
    np.testing.assert_allclose(got.item(), want, **LOSS_TOL)


def test_stdc_transform_targets_match_jax():
    """STDC's boundary targets of 2 x 37 x 29 labels in blocks, with an
    ignored band (its 255s enter the Laplacian): equal to the JAX
    head's."""
    rs = np.random.RandomState(5)
    gt = rs.randint(0, 4, (2, 5, 4)).repeat(8, 1).repeat(8, 2)[:, :37, :29]
    gt[:, 10:13] = 255
    cfg = dict(type='STDCHead', in_channels=8, channels=4, num_convs=1,
               num_classes=2, boundary_threshold=0.1, in_index=0,
               concat_input=False)
    want = np.asarray(run_jit(jax_build_head(dict(cfg)).transform_targets,
                              gt))
    got = build_head(dict(cfg)).transform_targets(torch.from_numpy(gt))
    assert 0 < want.mean() < 0.5
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------ the modules ------------------------------
def _feats(r):
    return [nchw(f) for f in r['out']['feats']]


@pytest.mark.parametrize('name', DEFS)
def test_segmentor_matches_jax(name, refs):
    """The def's segmentor from its config: every key filled from the JAX
    tree, and its taps, features, last logits and decoded features, the
    auxiliary logits and the resized logits within 1e-4 (PointRend's
    refined at its 48 most uncertain of 256 positions)."""
    r = refs(name)
    port = _port(name, r['variables'])
    img = nchw(r['img'])
    with torch.no_grad():
        taps = port.backbone(img)
        out = port(img)
        logits, states = port.encode_decode(img)
    want = r['out']
    _close(taps, want['taps'])
    _close(out['feats'], want['feats'])
    _close([out['decoded_features'], logits],
           [want['decoded'], want['logits']])
    _close(out['aux_logits'], want['aux_logits'])
    assert states['decoded_features'].shape == out['decoded_features'].shape


@pytest.mark.parametrize('name', ['ocrnet_r50-d8', 'pointrend_r50'])
def test_cascade_stages_match_jax(name, refs):
    """Each stage of the cascade on the JAX program's features, the later
    one also on the JAX stage's logits: OCR's and PointRend's logits (the
    refinement of 48 of 256 positions moves some) within 1e-4."""
    r = refs(name)
    port = _port(name, r['variables'])
    feats = _feats(r)
    stages = r['out']['stages']
    with torch.no_grad():
        first = port.decode_head[0](feats)[0]
        second = port.decode_head[1](feats, prev_logits=nchw(stages[0]))[0]
    _close([first, second], stages)
    if name == 'pointrend_r50':
        moved = np.abs(stages[1] - stages[0]).max(-1) > 0
        assert 0 < moved.sum() <= 2 * 48 and stages[0][0].size // 5 > 48


@pytest.mark.parametrize('name', ['knet_s3_fcn', 'knet_k3'])
def test_knet_stages_match_jax(name, refs):
    """K-Net's generate head and its three update stages, 1 x 1 and 3 x 3
    dynamic kernels, on the JAX program's features: every stage's logits
    within 1e-4."""
    r = refs(name)
    port = _port(name, r['variables'])
    with torch.no_grad():
        got, _ = port.decode_head.all_stage_logits(_feats(r))
    assert len(got) == 4
    _close(got, r['out']['stages'])


def test_ocr_head_alone_matches_jax():
    """OCR standing alone makes its own prior (``soft_regions``): its
    logits and features on random 6^2 maps within 1e-4 of the JAX
    head's."""
    cfg = dict(type='OCRHead', in_channels=16, channels=8, ocr_channels=8,
               num_classes=5, in_index=3, dropout_ratio=0.0, norm_cfg=NORM)
    rs = np.random.RandomState(7)
    feats = tuple(rs.randn(2, 6, 6, c).astype(np.float32)
                  for c in (4, 8, 8, 16))
    jhead = jax_build_head(dict(cfg))
    variables = jax_variables(jhead, [f.shape for f in feats])
    assert 'soft_regions' in variables['params']
    want = run_jit(lambda v, x: jhead.apply(v, x), variables, feats)
    holder = torch.nn.Module()
    holder.decode_head = build_head(dict(cfg))
    load_port(holder, {k: {'decode_head_mod': v}
                       for k, v in variables.items()})
    with torch.no_grad():
        got = holder.decode_head([nchw(f) for f in feats])
    _close(got, [np.asarray(w) for w in want])


def test_ocr_prior_gradient_matches_jax():
    """OCR as a later stage: the gradient of its weighted logits with
    respect to the previous stage's logits (not detached: OCR's loss
    reaches the stage before through them) and to its input, within 1e-4
    of ``jax.grad``'s."""
    cfg = dict(type='OCRHead', in_channels=16, channels=8, ocr_channels=8,
               num_classes=5, in_index=3, dropout_ratio=0.0, norm_cfg=NORM)
    rs = np.random.RandomState(11)
    feats = tuple(rs.randn(2, 6, 6, c).astype(np.float32)
                  for c in (4, 8, 8, 16))
    prior = rs.randn(2, 6, 6, 5).astype(np.float32)
    weight = rs.randn(2, 6, 6, 5).astype(np.float32)
    jhead = jax_build_head(dict(cfg))
    variables = jax_variables(jhead, [f.shape for f in feats])
    want = run_jit(jax.grad(lambda x, p: jnp.sum(jhead.apply(
        variables, x, prev_logits=p)[0] * weight), argnums=(0, 1)), feats,
        prior)
    holder = torch.nn.Module()
    holder.decode_head = build_head(dict(cfg))
    load_port(holder, {k: {'decode_head_mod': v}
                       for k, v in variables.items()})
    xs = [nchw(f).requires_grad_() for f in feats]
    p = nchw(prior).requires_grad_()
    (holder.decode_head(xs, prev_logits=p)[0] * nchw(weight)).sum().backward()
    assert p.grad.abs().max() > 0
    _close([xs[3].grad, p.grad], [np.asarray(want[0][3]),
                                  np.asarray(want[1])])


def test_point_losses_match_jax(monkeypatch):
    """PointRend's training points and their logits and labels from the
    same two uniform draws on both sides: the point logits within 1e-4,
    the labels equal, at 48 points of 144 candidates on a 16^2 map (36 by
    uncertainty, 12 uniform)."""
    cfg = dict(type='PointHead', in_channels=(16,), in_index=(0,),
               channels=16, num_fcs=3, coarse_pred_each_layer=True,
               num_points=48, dropout_ratio=0.0, num_classes=5,
               norm_cfg=NORM)
    rs = np.random.RandomState(8)
    feats = (rs.randn(2, 16, 16, 16).astype(np.float32),)
    coarse = rs.randn(2, 16, 16, 5).astype(np.float32)
    gt = rs.randint(0, 5, (2, 64, 64)).astype(np.int32)
    gt[:, :8] = 255
    draws = (rs.uniform(size=(2, 144, 2)).astype(np.float32),
             rs.uniform(size=(2, 12, 2)).astype(np.float32))
    by_shape = {d.shape: jnp.asarray(d) for d in draws}
    monkeypatch.setattr(jax.random, 'uniform',
                        lambda key, shape, *a, **k: by_shape[tuple(shape)])
    jhead = jax_build_head(dict(cfg))
    variables = jax_variables(jhead, [f.shape for f in feats])
    want = run_jit(lambda v, f, c, g: jhead.apply(
        v, f, g, coarse_logits=c, method=jhead.point_losses,
        rngs={'dropout': jax.random.PRNGKey(0)}), variables, feats, coarse,
        gt)
    holder = torch.nn.Module()
    holder.decode_head = build_head(dict(cfg))
    load_port(holder, {k: {'decode_head_mod': v}
                       for k, v in variables.items()})
    with torch.no_grad():
        logits, label = holder.decode_head.point_losses(
            [nchw(f) for f in feats], torch.from_numpy(gt),
            coarse_logits=nchw(coarse),
            draws=tuple(torch.from_numpy(d) for d in draws))
    assert logits.shape == (2, 48, 5)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want[0]), **TOL)
    np.testing.assert_array_equal(label.numpy(), np.asarray(want[1]))


# ------------------------------ the ResNet ------------------------------
def _resnet_cfg(**kw):
    return dict(type='ResNetV1c', num_stages=4, out_indices=(0, 1, 2, 3),
                dilations=(1, 1, 2, 4), strides=(1, 2, 1, 1), norm_cfg=NORM,
                contract_dilation=True, **R18, **kw)


def _resnet_step(port, img):
    """Train mode: the loss ``sum(tap^2) / n`` and its gradients."""
    port.train().zero_grad()
    loss = sum(t.square().mean() for t in port(img))
    loss.backward()
    return loss


def _jax_resnet_reference():
    """The JAX ResNetV1c-18 with ``with_cp`` and ``s2d_stem``: eval taps,
    and the train-mode loss, its gradients and the new BN statistics."""
    jmodel = jax_backbone(_resnet_cfg(with_cp=True, s2d_stem=True))
    variables = jax_variables(jmodel, (1, 32, 32, 3))
    img = np.random.RandomState(10).randn(2, 32, 32, 3).astype(np.float32)

    def run(v, x):
        taps = jmodel.apply(v, x)

        def loss_fn(params):
            outs, new = jmodel.apply({**v, 'params': params}, x, train=True,
                                     mutable=['batch_stats'])
            return sum(jnp.mean(t**2) for t in outs), new['batch_stats']
        (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            v['params'])
        return taps, loss, grads, stats

    with two_pass_batch_variance():
        taps, loss, grads, stats = run_jit(run, variables, img)
    # the trees under the segmentor's name of the backbone
    return ({k: {'backbone_mod': v} for k, v in variables.items()}, img,
            jax.tree.map(np.asarray, (taps, loss, {'backbone_mod': grads},
                                      {'backbone_mod': stats})))


def test_resnet_s2d_stem_and_with_cp_match_jax():
    """The JAX ResNet with ``s2d_stem`` and ``with_cp``: the port's eval
    taps within 1e-4; its train-mode loss, gradients and BN statistics
    after the backward (which recomputes each block: the statistics move
    once) within the step's tolerances."""
    variables, img, (taps, loss, grads, stats) = _jax_resnet_reference()
    holder = torch.nn.Module()
    holder.backbone = build_backbone(_resnet_cfg(with_cp=True, s2d_stem=True))
    load_port(holder, variables)
    with torch.no_grad():
        _close(holder.backbone(nchw(img)), taps)
    counts = {}
    for name, m in holder.named_modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.register_forward_hook(lambda mod, inp, out, name=name: counts
                                    .__setitem__(name, inp[0].numel() //
                                                 inp[0].shape[1]))
    got = _resnet_step(holder.backbone, nchw(img))
    np.testing.assert_allclose(got.item(), float(loss), rtol=2e-4, atol=2e-5)
    template = holder.state_dict()
    before = jax_variables_to_state_dict(variables, template)
    after = jax_variables_to_state_dict(
        {'params': grads, 'batch_stats': stats}, template)
    for key, p in holder.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), after[key].numpy(),
                                   rtol=1e-3, atol=3e-5, err_msg=key)
    n_stats = 0
    for key, value in template.items():
        name, leaf = key.rsplit('.', 1)
        if leaf == 'running_var':
            c = counts[name] / (counts[name] - 1)
            want = c * after[key] - (c - 1) * 0.9 * before[key]
        elif leaf == 'running_mean':
            want = after[key]
        else:
            continue
        n_stats += 1
        np.testing.assert_allclose(value.numpy(), want.numpy(), rtol=2e-3,
                                   atol=2e-4, err_msg=key)
    assert n_stats == 2 * len(counts) > 40


def test_with_cp_step_matches_the_plain_step():
    """A train-mode step with ``with_cp`` and one without, from the same
    weights: the same loss, gradients, and parameters after an SGD step,
    and the running statistics moved once, not again by the recomputation
    (the counts too)."""
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(0))
    sides = []
    for cp in (False, True):
        torch.manual_seed(0)
        net = build_backbone(_resnet_cfg(with_cp=cp))
        opt = torch.optim.SGD(net.parameters(), lr=0.1)
        loss = _resnet_step(net, x)
        opt.step()
        sides.append((loss, [p.grad for p in net.parameters()],
                      net.state_dict()))
    (loss0, grads0, sd0), (loss1, grads1, sd1) = sides
    assert loss0.item() == loss1.item()
    for g0, g1 in zip(grads0, grads1):
        torch.testing.assert_close(g1, g0, rtol=1e-6, atol=1e-7)
    for key in sd0:
        torch.testing.assert_close(sd1[key], sd0[key], rtol=1e-6, atol=1e-7)
    assert int(sd1['layer1.0.bn1.num_batches_tracked']) == 1


# ------------------------------- the keys -------------------------------
def test_keys_of_the_new_modules():
    """A cascade's stages under ``stage_heads_{i}``, OCR's, PointRend's
    and K-Net's modules under the JAX file's names, STDC's net under its
    ``backbone/STDCNet_0``."""
    cases = [
        ('decode_head.1.query.weight', 4, 'params/stage_heads_1/query/kernel'),
        ('decode_head.1.key.weight', 2, 'params/stage_heads_1/key/kernel'),
        ('decode_head.1.fuse.bn.running_mean', 1,
         'batch_stats/stage_heads_1/fuse/norm/bn/mean'),
        ('decode_head.1.bottleneck.conv.weight', 4,
         'params/stage_heads_1/bottleneck/conv/kernel'),
        ('decode_head.0.conv_seg.bias', 1,
         'params/stage_heads_0/cls/conv_seg/bias'),
        ('decode_head.soft_regions.bias', 1,
         'params/decode_head_mod/soft_regions/bias'),
        ('decode_head.1.fc2.weight', 2, 'params/stage_heads_1/fc2/kernel'),
        ('decode_head.1.point_cls.bias', 1,
         'params/stage_heads_1/point_cls/bias'),
        ('decode_head.coarse_cls.conv_seg.weight', 4,
         'params/decode_head_mod/coarse_cls/conv_seg/kernel'),
        ('decode_head.kgh.convs.1.bn.weight', 1,
         'params/decode_head_mod/kgh/conv1/norm/bn/scale'),
        ('decode_head.kgh.conv_seg.weight', 4,
         'params/decode_head_mod/kgh/cls/conv_seg/kernel'),
        ('decode_head.update_head2.kernel_update_conv.norm_in.weight', 1,
         'params/decode_head_mod/update_head2/kernel_update_conv/norm_in/'
         'scale'),
        ('decode_head.update_head0.attention.qkv.weight', 2,
         'params/decode_head_mod/update_head0/attention/qkv/kernel'),
        ('decode_head.update_head1.mask_fc0.weight', 2,
         'params/decode_head_mod/update_head1/mask_fc0/kernel'),
        ('decode_head.update_head1.feat_transform.conv.bias', 1,
         'params/decode_head_mod/update_head1/feat_transform/conv/bias'),
        ('decode_head.fuse.0.conv.weight', 4,
         'params/decode_head_mod/fuse0/conv/kernel')]
    for key, ndim, path in cases:
        coll, *path = path.split('/')
        assert torch_key_to_flax(key, ndim) == (coll, path), key
    assert torch_key_to_flax('backbone.backbone.STDCNet_0.s1b0c2.bn.bias', 1,
                             backbone='cnn') == (
        'params', ['backbone_mod', 'backbone', 'STDCNet_0', 's1b0c2', 'norm',
                   'bn', 'bias'])
    with torch.device('meta'):
        port = build_segmentor(tiny_cfg('ocrnet_r50-d8'))
    paths = param_paths(port.named_parameters(), **key_families(port))
    assert paths['decode_head.1.value.bias'] == 'stage_heads_1/value/bias'
    assert not any('soft_regions' in k for k in port.state_dict())


def _port_shape(shape, path, ndim):
    """A JAX leaf's shape in the port's layout (``core.convert``)."""
    if len(shape) == 4:
        return (shape[3], shape[2], shape[0], shape[1])
    if len(shape) == 2 and path[-1] == 'kernel':
        return (shape[1], shape[0]) + (1, 1) * (ndim == 4)
    return tuple(shape)


@pytest.mark.parametrize('name', FULL_DEFS)
def test_full_width_state_dict_matches_the_jax_tree(name):
    """The def as its config stands: the port built on the meta device,
    the JAX tree from ``jax.eval_shape`` of ``init`` at 64^2; each key of
    the port maps to a JAX leaf of its shape, no two keys to one leaf,
    and every leaf has a key (PointRend's 275-wide point MLP, K-Net's
    three stages, no ``soft_regions``, ``coarse_conv`` or ``coarse_cls``
    under the cascades)."""
    cfg = Config.fromfile(osp.join(CONFIGS, f'{name}.py')).to_dict()['model']
    with torch.device('meta'):
        port = build_segmentor(copy.deepcopy(cfg))
    jmodel = jax_segmentor(copy.deepcopy(cfg))
    tree = jax.eval_shape(lambda: jmodel.init(
        {'params': jax.random.PRNGKey(0)}, jnp.zeros((1, 64, 64, 3))))
    leaves = {tuple(getattr(k, 'key', k) for k in path): leaf.shape
              for path, leaf in jax.tree_util.tree_leaves_with_path(
                  dict(tree))}
    sd = port.state_dict()
    seen, bad, n = set(), [], 0
    for key, ref in sd.items():
        if key.endswith('num_batches_tracked'):
            continue
        n += 1
        mapped = torch_key_to_flax(key, ref.ndim, **key_families(port))
        path = None if mapped is None else (mapped[0], *mapped[1])
        if path not in leaves or _port_shape(leaves[path], path,
                                             ref.ndim) != tuple(ref.shape):
            bad.append((key, tuple(ref.shape), leaves.get(path)))
        seen.add(path)
    assert not bad
    assert set(leaves) == seen and len(seen) == n


# -------------------------------- training --------------------------------
def _jax_step(name, variables, batch, mean, std):
    jmodel = jax_segmentor(tiny_cfg(name))
    tx = jax_opt.build_optimizer(SGD)
    jstate = UDATrainState(
        params=variables['params'],
        batch_stats=variables.get('batch_stats', {}),
        ema_params={}, ema_batch_stats={},
        opt_state=tx.init(variables['params']), step=jnp.zeros((), jnp.int32))
    step_fn = JaxTrainer(jmodel).make_train_step(tx, mean, std, jit=False)
    with two_pass_batch_variance():
        compiled = jax.jit(step_fn).lower(jstate, batch, jax.random.PRNGKey(0)
                                          ).compile(FAST_COMPILE)
    new_state, log_vars, _ = compiled(jstate, batch, jax.random.PRNGKey(0))
    return new_state, log_vars


def _acc_logits(student, img, gt):
    """Each accuracy log var's logits and labels in a train-mode forward
    of a copy of ``student``."""
    student = copy.deepcopy(student)
    dh = student.decode_head
    with torch.no_grad():
        out = student(img)
        if hasattr(dh, 'all_stage_logits'):
            stages, _ = dh.all_stage_logits(out['feats'])
            pairs = {f'decode.acc_seg.s{i}': (lg, dh, gt)
                     for i, lg in enumerate(stages)}
        elif isinstance(dh, torch.nn.ModuleList):
            pairs = {f'decode_{i}.acc_seg': (lg, h, gt) for i, (lg, h) in
                     enumerate(zip(out['stage_logits'], dh))}
        else:
            pairs = {'decode.acc_seg': (out['seg_logits'], dh, gt)}
    heads = student._aux_heads()
    for i, (lg, h) in enumerate(zip(out['aux_logits'], heads)):
        prefix = 'aux' if len(heads) == 1 else f'aux_{i}'
        pairs[f'{prefix}.acc_seg'] = (lg, h, gt)
    return pairs


def _near_ties(student, img, gt):
    """By accuracy log var, the share (in points) of labelled pixels whose
    two highest logits lie within the forward tolerance (1e-4) in a
    train-mode forward: argmax ties that fp32 summed in another order may
    break either way."""
    share = {}
    for key, (logits, head, labels) in _acc_logits(student, img, gt).items():
        if hasattr(head, 'transform_targets'):
            labels = head.transform_targets(labels)
        valid = labels != 255
        logits = resize(logits.float(), size=labels.shape[1:],
                        mode='bilinear', align_corners=head.align_corners)
        top2 = logits.topk(2, dim=1).values
        near = (top2[:, 0] - top2[:, 1] < TOL['atol']) & valid
        share[key] = 100.0 * float(near.sum()) / float(valid.sum())
    return share


STEP_KEYS = {
    'ocrnet_r50-d8': {'decode_0.loss_ce', 'decode_1.loss_ce',
                      'decode_1.acc_seg'},
    'pointrend_r50': {'decode_0.loss_ce', 'decode_1.pointloss_ce',
                      'decode_1.acc_point'},
    'knet_s3_fcn': {f'decode.loss_ce.s{i}' for i in range(4)} | {
        'aux.loss_ce'},
    'stdc': {'decode.loss_ce', 'aux_0.loss_ce', 'aux_1.loss_ce',
             'aux_2.loss_ce', 'aux_2.loss_dice'}}


@pytest.mark.parametrize('name', sorted(STEP_KEYS))
def test_supervised_sgd_step_matches_jax(name, refs, monkeypatch):
    """One SGD step of ``SupervisedTrainer`` against the JAX trainer's
    from the same weights and batch (PointRend's point draws the same on
    both sides): log vars (each cascade stage's, the point loss, K-Net's
    four stages, STDC's OHEM heads and boundary CE and Dice) and every
    parameter and BN statistic after the step. OCR's loss reaches the FCN
    stage through its prior, K-Net's stages reach the generate head's
    classifier through the kernels."""
    variables = refs(name)['variables']
    rs = np.random.RandomState(6)
    img = _images(rs, 2)
    gt = rs.randint(0, 4, (2, SIZE, SIZE)).astype(np.int32)
    if name == 'stdc':
        gt = rs.randint(0, 4, (2, 8, 8)).repeat(8, 1).repeat(8, 2).astype(
            np.int32)
    gt[:, :2] = 255
    mean, std = [120.0, 110.0, 100.0], [60.0, 55.0, 58.0]
    if name == 'pointrend_r50':
        draws = (rs.uniform(size=(2, 144, 2)).astype(np.float32),
                 rs.uniform(size=(2, 12, 2)).astype(np.float32))
        by_shape = {d.shape: jnp.asarray(d) for d in draws}
        monkeypatch.setattr(jax.random, 'uniform',
                            lambda key, shape, *a, **k:
                            by_shape[tuple(shape)])
        point_losses = PointRendHead.point_losses
        monkeypatch.setattr(
            PointRendHead, 'point_losses',
            lambda self, *a, **k: point_losses(
                self, *a, draws=tuple(torch.from_numpy(d) for d in draws),
                **k))
    new_state, ref_vars = _jax_step(name, variables,
                                    {'img': img, 'gt_semantic_seg': gt},
                                    mean, std)
    algo = build_algorithm({'model': tiny_cfg(name)}, device='cpu')
    state = algo.init_state(torch.Generator().manual_seed(0),
                            build_optimizer(SGD))
    load_port(state.student, variables).train()
    ties_share = _near_ties(state.student, nchw(img), torch.from_numpy(gt))
    counts = {}
    hooks = [m.register_forward_hook(
        lambda mod, inp, out, n=n: counts.__setitem__(
            n, inp[0].numel() // inp[0].shape[1]))
        for n, m in state.student.named_modules()
        if isinstance(m, torch.nn.BatchNorm2d)]
    state, got = algo.make_train_step(mean, std)(
        state, {'img': nchw(img), 'gt_semantic_seg': torch.from_numpy(gt)},
        torch.Generator().manual_seed(1))
    for hk in hooks:
        hk.remove()
    assert sorted(got) == sorted(ref_vars) and STEP_KEYS[name] <= set(got)
    for k in ref_vars:
        # an accuracy may also differ by its pixels at an argmax tie
        np.testing.assert_allclose(got[k].item(), float(ref_vars[k]),
                                   rtol=2e-4,
                                   atol=2e-5 + ties_share.get(k, 0.0),
                                   err_msg=k)
    template = state.student.state_dict()
    families = key_families(state.student)
    before = jax_variables_to_state_dict(variables, template, **families)
    after = jax_variables_to_state_dict(
        {'params': new_state.params, 'batch_stats': new_state.batch_stats},
        template, **families)
    m, moved = 0.1, set()
    for key, value in template.items():
        n, leaf = key.rsplit('.', 1)
        if leaf == 'num_batches_tracked':
            continue
        if leaf == 'running_var':
            c = counts[n] / (counts[n] - 1)
            want = c * after[key] - (c - 1) * (1 - m) * before[key]
            tol = dict(rtol=2e-3, atol=2e-4)
        elif leaf == 'running_mean':
            want, tol = after[key], dict(rtol=2e-3, atol=2e-4)
        else:
            want, tol = after[key], dict(rtol=1e-3, atol=3e-5)
            if (value - before[key]).abs().max() > 0:
                moved.add(key)
        np.testing.assert_allclose(value.numpy(), want.numpy(),
                                   err_msg=key, **tol)
    assert len(moved) > 10
