"""The port's transformer backbones with a relative-position bias (BEiT,
MAE, Swin), the ``Feature2Pyramid`` neck, their UPerNet segmentors, and
the attention with the library's bias ``ab`` that they run on, against
the JAX package on the CPU.

The configs are ``configs/_base_/models/upernet_{beit,mae,swin}.py`` cut
to narrow widths and two levels: BEiT and MAE 2 layers of 32 wide, 2
heads (img 32, patch 8: N = 17 tokens), both taps through
``Feature2Pyramid`` at rescales (1, 0.5) (its own test takes all four);
Swin 32 wide, depths (2, 2), heads (1, 2), so every head is 32 wide as in
Swin-T, on 36^2 inputs: a 9^2 patch grid that pads to 14^2 (4 windows),
merged to 5^2 (padded to 7^2, one window), a shifted block in each stage.
The UPerHead and the FCN head take the two levels (the step tests take
an FCN head as decode head, ``step_cfg``). Weights come from
``torch_parity.jax_variables`` (numpy draws in the JAX layout, tables,
layer scales and q/v biases included) through
``jax_variables_to_state_dict``. One JAX program a family computes the
backbone's, the neck's and the segmentor's outputs, shared by the tests
(and across xdist's workers) through ``torch_parity.shared_by_workers``.
Attention runs its plain version here with ``ab = bias / scale`` (the
kernels take the library's order, bias before the scale);
``chip_smoke.py`` holds the card's kernels to it.

Tolerances: ``test_torch_vit.py``'s. Forward atol 1e-4, rtol 1e-4 (fp32
in another order); the step's log vars rtol 2e-4, atol 2e-5, post-step
parameters rtol 1e-3, atol 3e-5, BN statistics rtol 2e-3, atol 2e-4
after the n/(n-1) gap of ROADMAP C2. Swin's bias fold at d = 32, where
the scale 32^-1/2 is no power of two, rounds ``bias / scale`` once more
than JAX's ``bias`` after the scale: one fp32 ulp of a logit of order
one, 1e-7, far inside 1e-4, so Swin needs no more. The plain attention
with ``ab`` against ``mha_reference``: 1e-5 as in
``test_torch_attention.py`` (the same formula, sums in another order).
"""
import copy
import importlib
import os.path as osp
import sys
import types

import numpy as np
import pytest
import torch

# torch's OpenMP pool must not run beside XLA-CPU in one process
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas.ops.tpu.flash_attention import \
    mha_reference  # noqa: E402

from torch_parity import (FAST_COMPILE, jax_variables, load_port,  # noqa: E402
                          nchw, nhwc, run_jit, shared_by_workers,
                          two_pass_batch_variance)

from pfst_tpu.apis.train import SupervisedTrainer as JaxTrainer  # noqa: E402
from pfst_tpu.core import optimizers as jax_opt  # noqa: E402
from pfst_tpu.models import build_neck as jax_build_neck  # noqa: E402
from pfst_tpu.models import build_segmentor as jax_segmentor  # noqa: E402
from pfst_tpu.models.uda.uda_decorator import UDATrainState  # noqa: E402
from pfst_tpu_torch.apis import (build_algorithm, init_segmentor,  # noqa: E402
                                 make_inference_fn)
from pfst_tpu_torch.core import (build_optimizer,  # noqa: E402
                                 jax_variables_to_state_dict)
from pfst_tpu_torch.core import optimizers as port_opt  # noqa: E402
from pfst_tpu_torch.core.convert import key_families  # noqa: E402
from pfst_tpu_torch.models import build_neck, build_segmentor  # noqa: E402
from pfst_tpu_torch.ops import (attention, torch_attention,  # noqa: E402
                                torch_attention_backward)
from pfst_tpu_torch.utils import Config  # noqa: E402

sys.path.insert(0, osp.join(osp.dirname(__file__), '..', 'tools'))
from convert_torch_checkpoint import \
    convert_transformer_state_dict  # noqa: E402

# the module (``pfst_tpu_torch.ops.attention`` is also its function's name)
attn_mod = importlib.import_module('pfst_tpu_torch.ops.attention')
CONFIGS = osp.join(osp.dirname(__file__), '..', 'configs', '_base_',
                   'models')
TOL = dict(atol=1e-4, rtol=1e-4)
MEAN = [123.675, 116.28, 103.53]
STD = [58.395, 57.12, 57.375]
SGD = dict(type='SGD', lr=1e-2)
SIZE = {'beit': 32, 'mae': 32, 'swin': 36}


def tiny_cfg(family, drop_path_rate=0.0):
    """``upernet_{family}.py`` at narrow widths (module docstring)."""
    cfg = Config.fromfile(osp.join(CONFIGS, f'upernet_{family}.py')
                          ).to_dict()['model']
    if family == 'swin':
        cfg['backbone'].update(embed_dims=32, depths=(2, 2),
                               num_heads=(1, 2), out_indices=(0, 1),
                               drop_path_rate=drop_path_rate)
        chans = (32, 64)
    else:
        cfg['backbone'].update(img_size=32, patch_size=8, embed_dims=32,
                               num_layers=2, num_heads=2,
                               out_indices=(0, 1),
                               drop_path_rate=drop_path_rate)
        cfg['neck'].update(embed_dim=32, rescales=(1, 0.5))
        chans = (32,) * 2
    cfg['decode_head'].update(in_channels=chans, in_index=(0, 1),
                              channels=8, num_classes=5, dropout_ratio=0.0)
    cfg['auxiliary_head'].update(in_channels=chans[1], in_index=1,
                                 channels=8, num_classes=5,
                                 dropout_ratio=0.0)
    return cfg


def _images(rs, b, size):
    """Normal noise, each image shifted by its own offset (train-mode BN
    of the 1x1 pooled PPM branch normalizes one value per image)."""
    shift = np.linspace(-2.0, 2.0, b).reshape(b, 1, 1, 1)
    return (rs.randn(b, size, size, 3) + shift).astype(np.float32)


def _jax_reference(family):
    """The JAX model's variables, and on two seeded images its backbone
    taps, neck outputs, logits and decoded features (numpy)."""
    cfg = tiny_cfg(family)
    jmodel = jax_segmentor(copy.deepcopy(cfg))
    size = SIZE[family]
    variables = jax_variables(jmodel, (1, size, size, 3))
    img = _images(np.random.RandomState(4), 2, size)

    def run(v, x):
        taps = jmodel.apply(v, x, method=lambda m, t: m.backbone_mod(t))
        logits, states = jmodel.apply(v, x, method=jmodel.encode_decode)
        return taps, states['feats'], logits, states['decoded_features']

    out = run_jit(run, variables, img)
    return dict(variables=jax.tree.map(np.asarray, variables), img=img,
                out=jax.tree.map(np.asarray, out))


@pytest.fixture(scope='module')
def refs(tmp_path_factory):
    cache = {}

    def get(family):
        if family not in cache:
            cache[family] = shared_by_workers(
                tmp_path_factory, f'transformers_{family}',
                lambda: _jax_reference(family))
        return cache[family]
    return get


def _port(family, variables, **backbone):
    cfg = tiny_cfg(family)
    cfg['backbone'].update(backbone)
    return load_port(build_segmentor(cfg), variables)


# ------------------------- attention with the bias -------------------------
def _qkvg(shape, seed):
    rs = np.random.RandomState(seed)
    return [rs.randn(*shape).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize('kind', ['batch_shared', 'asymmetric'])
def test_plain_attention_with_ab_matches_mha_reference(kind):
    """Forward, LSE and the backward, dab included, against the library's
    ``mha_reference`` and its VJP (scale folded into q and ab: its VJP
    takes only ``sm_scale == 1``); a batch-shared (1, H, N, N) bias is
    broadcast on the JAX side, whose VJP then sums it over the batch."""
    shape = (2, 3, 37, 16)
    b, h, n, _ = shape
    q, k, v, g = _qkvg(shape, 7)
    rs = np.random.RandomState(8)
    ab = (rs.randn(1 if kind == 'batch_shared' else b, h, n, n) * 3.0
          ).astype(np.float32)
    assert not np.allclose(ab, ab.transpose(0, 1, 3, 2))
    scale = shape[-1]**-0.5
    full = np.broadcast_to(ab, (b, h, n, n))
    ref = mha_reference(q, k, v, full, sm_scale=scale)
    tq, tk, tv, tg, tab = (torch.from_numpy(a) for a in (q, k, v, g, ab))
    out, lse = torch_attention(tq, tk, tv, scale, return_lse=True, ab=tab)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)
    s = (np.einsum('bhqd,bhkd->bhqk', q, k).astype(np.float64) + full) * \
        scale
    np.testing.assert_allclose(lse.numpy(), np.log(np.exp(s).sum(-1)),
                               rtol=1e-6)
    _, vjp = jax.vjp(
        lambda q_, k_, v_, ab_: mha_reference(
            q_ * scale, k_, v_, jnp.broadcast_to(ab_, (b, h, n, n)) * scale,
            sm_scale=1.0), q, k, v, ab)
    want = [np.asarray(r) for r in vjp(jnp.asarray(g))]
    dq, dk, dv, dab = torch_attention_backward(tq, tk, tv, out, lse, tg,
                                               scale, ab=tab)
    summed = dab.sum(0, keepdim=True) if kind == 'batch_shared' else dab
    xs = [t.clone().requires_grad_() for t in (tq, tk, tv, tab)]
    auto = torch.autograd.grad(attention(*xs[:3], scale, xs[3]), xs, tg)
    for name, got, a, r in zip(('dq', 'dk', 'dv', 'dab'),
                               (dq, dk, dv, summed), auto, want):
        assert got.shape == a.shape == r.shape, name
        np.testing.assert_allclose(got.numpy(), r, atol=1e-5, rtol=1e-5,
                                   err_msg=f'{name} vs mha_reference')
        np.testing.assert_allclose(got.numpy(), a.numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=f'{name} vs autograd')


class _StubLibrary:
    """Stands in for the built kernels: records each launch's pointers
    and bias strides and returns success; the outputs stay as allocated."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith('pfst_flash_attention_'):
            raise AttributeError(name)

        def launch(*args):
            self.calls.append((name[len('pfst_flash_attention_'):], args))
            return 0
        return launch


def test_cuda_tensors_with_ab_never_reach_the_plain_version(monkeypatch):
    """``attention`` hands a CUDA q (and its ab) to the kernels' autograd
    Function; that Function, with the library stubbed and the plain
    versions made to raise, launches the forward with ab's pointer and a
    batch stride of 0 for a (1, H, N, N) bias, both backward kernels with
    it, dQ with a dab to write, and returns dab summed over the batch as
    ab's gradient. The wrappers refuse an ab that is not fp32 or not (1
    or B, H, N, N)."""
    applied = []
    monkeypatch.setattr(attn_mod._FlashAttention, 'apply',
                        lambda *a: applied.append(a) or 'kernels')
    fake_q = types.SimpleNamespace(device=torch.device('cuda'))
    marker = object()
    assert attention(fake_q, fake_q, fake_q, 0.5, marker) == 'kernels'
    assert applied == [(fake_q, fake_q, fake_q, marker, 0.5)]
    monkeypatch.undo()

    def plain(*args, **kwargs):
        raise AssertionError('a CUDA tensor reached the plain version')
    lib = _StubLibrary()
    monkeypatch.setattr(attn_mod, 'torch_attention', plain)
    monkeypatch.setattr(attn_mod, 'torch_attention_backward', plain)
    monkeypatch.setattr(attn_mod, '_library', lambda: lib)
    monkeypatch.setattr(attn_mod, '_device_and_stream', lambda t: (0, None))
    monkeypatch.setattr(attn_mod, '_check_kernel_input',
                        lambda q, k, v: attn_mod._check_args(q, k, v))
    b, h, n, d = 2, 3, 17, 32
    q, k, v = (torch.randn(b, h, n, d, requires_grad=True)
               for _ in range(3))
    ab = torch.randn(1, h, n, n, requires_grad=True)
    out = attn_mod._FlashAttention.apply(q, k, v, ab, d**-0.5)
    out.backward(torch.ones_like(out))
    assert [c[0] for c in lib.calls] == ['forward', 'bwd_dkv', 'bwd_dq']
    fwd, dkv, dq = (c[1] for c in lib.calls)
    assert fwd[5] == dkv[6] == dq[6] == ab.data_ptr()
    assert dq[8] is not None
    for args in (fwd, dkv, dq):
        bias_strides = list(args[-5])
        assert bias_strides[:3] == [0, n * n, n]
    assert list(dq[-5])[3:] == [h * n * n, n * n, n]
    assert ab.grad.shape == ab.shape
    with pytest.raises(TypeError, match='float32 ab'):
        attn_mod.cuda_flash_attention(q.detach(), k.detach(), v.detach(),
                                      0.1, ab.detach().double())
    with pytest.raises(ValueError, match='ab must be'):
        attn_mod.cuda_flash_attention(q.detach(), k.detach(), v.detach(),
                                      0.1, torch.zeros(h, n, n))


# -------------------------- backbones and the neck --------------------------
@pytest.mark.parametrize('family', ['beit', 'mae', 'swin'])
def test_backbone_matches_jax(family, refs):
    """Every tap within 1e-4: BEiT and MAE (abs ``pos_embed``, no q/v
    bias), Swin with padding and shifted windows."""
    r = refs(family)
    port = _port(family, r['variables']).backbone
    with torch.no_grad():
        outs = port(nchw(r['img']))
    taps = r['out'][0]
    assert len(outs) == len(taps) == 2
    for got, want in zip(outs, taps):
        np.testing.assert_allclose(nhwc(got), want, **TOL)


def test_beit_grid_mismatch_raises_as_jax(refs):
    r = refs('beit')
    port = _port('beit', r['variables'])
    with pytest.raises(ValueError, match='patch grid'):
        port.backbone(torch.zeros(1, 3, 48, 48))


def test_feature2pyramid_matches_jax():
    cfg = Config.fromfile(osp.join(CONFIGS, 'upernet_beit.py')
                          ).to_dict()['model']['neck']
    assert cfg['rescales'] == (4, 2, 1, 0.5)
    rs = np.random.RandomState(1)
    feats = tuple(rs.randn(2, 5, 5, 8).astype(np.float32) for _ in range(4))
    jneck = jax_build_neck(dict(cfg))
    ref = run_jit(lambda x: jneck.apply({}, x), feats)
    port = build_neck(dict(cfg))
    assert not list(port.parameters())
    outs = port([nchw(f) for f in feats])
    assert [o.shape[-1] for o in outs] == [20, 10, 5, 2]
    for got, want in zip(outs, ref):
        np.testing.assert_allclose(nhwc(got), np.asarray(want), **TOL)


@pytest.mark.parametrize('family', ['beit', 'mae', 'swin'])
def test_upernet_segmentor_matches_jax(family, refs):
    r = refs(family)
    port = _port(family, r['variables'])
    with torch.no_grad():
        feats = port.neck(port.backbone(nchw(r['img']))) \
            if port.neck is not None else port.backbone(nchw(r['img']))
        logits, states = port.encode_decode(nchw(r['img']))
    _, ref_feats, ref_logits, ref_decoded = r['out']
    for got, want in zip(feats, ref_feats):
        np.testing.assert_allclose(nhwc(got), want, **TOL)
    np.testing.assert_allclose(nhwc(logits), ref_logits, **TOL)
    np.testing.assert_allclose(nhwc(states['decoded_features']),
                               ref_decoded, **TOL)


@pytest.mark.parametrize('family', ['beit', 'mae', 'swin'])
def test_state_dict_under_mmseg_names(family, refs, tmp_path):
    """The port's backbone keys are mmseg's: the JAX package's own
    converter maps them back to the JAX tree leaf for leaf (Swin's merge
    weights through its unfold-order correction), and a saved state dict,
    with an mmseg checkpoint's index buffer beside it, serves the same
    logits; a missing key is named."""
    r = refs(family)
    port = _port(family, r['variables'])
    sd = port.state_dict()
    keys = {'beit': ['backbone.layers.1.attn.qkv.weight',
                     'backbone.layers.0.attn.q_bias',
                     'backbone.layers.0.attn.v_bias',
                     'backbone.layers.1.attn.relative_position_bias_table',
                     'backbone.layers.1.gamma_1', 'backbone.layers.1.gamma_2',
                     'backbone.layers.0.ffn.layers.0.0.weight',
                     'backbone.patch_embed.projection.weight',
                     'backbone.cls_token'],
            'mae': ['backbone.pos_embed', 'backbone.layers.0.gamma_1',
                    'backbone.layers.0.attn.relative_position_bias_table'],
            'swin': ['backbone.patch_embed.norm.weight',
                     'backbone.stages.0.blocks.1.attn.w_msa.qkv.weight',
                     'backbone.stages.0.blocks.1.attn.w_msa.'
                     'relative_position_bias_table',
                     'backbone.stages.0.downsample.reduction.weight',
                     'backbone.stages.0.downsample.norm.bias',
                     'backbone.stages.1.blocks.1.attn.w_msa.'
                     'relative_position_bias_table',
                     'backbone.stages.1.blocks.0.ffn.layers.1.weight',
                     'backbone.norm1.weight']}[family]
    for key in keys:
        assert key in sd, key
    assert not any('relative_position_index' in k for k in sd)
    if family == 'mae':
        assert 'backbone.layers.0.attn.q_bias' not in sd
    params, _, skipped = convert_transformer_state_dict(
        sd, 'swin' if family == 'swin' else 'beit')
    want = dict(jax.tree_util.tree_leaves_with_path(
        r['variables']['params']['backbone_mod']))
    got = jax.tree_util.tree_leaves_with_path(params['backbone_mod'])
    assert len(got) == len(want)
    for path, leaf in got:
        np.testing.assert_array_equal(leaf, want[path], err_msg=str(path))
    # an mmseg checkpoint also carries each layer's index buffer
    index = ('backbone.stages.0.blocks.1.attn.w_msa.relative_position_index'
             if family == 'swin' else
             'backbone.layers.1.attn.relative_position_index')
    path = tmp_path / f'{family}.pth'
    torch.save(dict(sd, **{index: torch.zeros(3, dtype=torch.long)}), path)
    cfg = tiny_cfg(family)
    loaded = init_segmentor(Config(dict(model=cfg)), str(path), device='cpu')
    img = nchw(r['img'][:1])
    torch.testing.assert_close(make_inference_fn(loaded)(img),
                               make_inference_fn(port)(img), rtol=0, atol=0)
    cut = copy.deepcopy(r['variables'])
    name = {'beit': 'layers_1', 'mae': 'layers_1', 'swin': 'merge_norm1'}
    del cut['params']['backbone_mod'][name[family]]
    with pytest.raises(KeyError, match='backbone.'):
        jax_variables_to_state_dict(cut, port.state_dict(),
                                    **key_families(port))


# --------------------------------- training ---------------------------------
def step_cfg(family):
    """``tiny_cfg`` with an FCN head on the last level as the decode head
    (the auxiliary head's, at loss weight 1): the step's claim is the
    backbone's gradients, its tables' among them; the UPerHead's forward
    is held above and its step in ``test_torch_vit.py``, and the FCN head
    halves the JAX step's tracing and compile."""
    cfg = tiny_cfg(family)
    head = copy.deepcopy(cfg['auxiliary_head'])
    head['loss_decode'] = dict(head['loss_decode'], loss_weight=1.0)
    cfg['decode_head'] = head
    return cfg


def _jax_step(family, variables, batch):
    jmodel = jax_segmentor(step_cfg(family))
    tx = jax_opt.build_optimizer(SGD)
    jstate = UDATrainState(
        params=variables['params'], batch_stats=variables['batch_stats'],
        ema_params={}, ema_batch_stats={},
        opt_state=tx.init(variables['params']), step=jnp.zeros((), jnp.int32))
    step_fn = JaxTrainer(jmodel).make_train_step(tx, MEAN, STD, jit=False)
    with two_pass_batch_variance():
        compiled = jax.jit(step_fn).lower(jstate, batch, jax.random.PRNGKey(0)
                                          ).compile(FAST_COMPILE)
    new_state, log_vars, _ = compiled(jstate, batch, jax.random.PRNGKey(0))
    return new_state, log_vars


@pytest.mark.parametrize('family', ['beit', 'mae', 'swin'])
def test_supervised_sgd_step_matches_jax(family):
    """One SGD step of ``SupervisedTrainer`` against the JAX trainer's
    from the same weights and batch (drop path 0): log vars and every
    parameter after the step, the tables and layer scales included."""
    size = SIZE[family]
    variables = jax_variables(jax_segmentor(step_cfg(family)),
                              (1, size, size, 3))
    rs = np.random.RandomState(6)
    img = _images(rs, 2, size)
    gt = rs.randint(0, 5, (2, size, size)).astype(np.int32)
    gt[:, :2] = 255
    new_state, ref_vars = _jax_step(family, variables,
                                    {'img': img, 'gt_semantic_seg': gt})
    algo = build_algorithm({'model': step_cfg(family)}, device='cpu')
    state = algo.init_state(torch.Generator().manual_seed(0),
                            build_optimizer(SGD))
    load_port(state.student, variables).train()
    counts = {}
    hooks = [m.register_forward_hook(
        lambda mod, inp, out, name=name: counts.__setitem__(
            name, inp[0].numel() // inp[0].shape[1]))
        for name, m in state.student.named_modules()
        if isinstance(m, torch.nn.BatchNorm2d)]
    state, got = algo.make_train_step(MEAN, STD)(
        state, {'img': nchw(img), 'gt_semantic_seg': torch.from_numpy(gt)},
        torch.Generator().manual_seed(1))
    for hk in hooks:
        hk.remove()
    assert sorted(got) == sorted(ref_vars)
    for k in ref_vars:
        np.testing.assert_allclose(got[k].item(), float(ref_vars[k]),
                                   rtol=2e-4, atol=2e-5, err_msg=k)
    template = state.student.state_dict()
    families = key_families(state.student)
    before = jax_variables_to_state_dict(variables, template, **families)
    after = jax_variables_to_state_dict(
        {'params': new_state.params, 'batch_stats': new_state.batch_stats},
        template, **families)
    m = 0.1
    for key, value in template.items():
        name, leaf = key.rsplit('.', 1)
        if leaf == 'num_batches_tracked':
            continue
        if leaf == 'running_var':
            c = counts[name] / (counts[name] - 1)
            want = c * after[key] - (c - 1) * (1 - m) * before[key]
            tol = dict(rtol=2e-3, atol=2e-4)
        elif leaf == 'running_mean':
            want, tol = after[key], dict(rtol=2e-3, atol=2e-4)
        else:
            want, tol = after[key], dict(rtol=1e-3, atol=3e-5)
        np.testing.assert_allclose(value.numpy(), want.numpy(),
                                   err_msg=key, **tol)
    tables = [k for k in template if k.endswith('bias_table')]
    assert tables and all(
        float((template[k] - before[k]).abs().max()) > 0 for k in tables)


@pytest.mark.parametrize('family', ['vit', 'beit', 'swin'])
def test_with_cp_gives_the_same_loss_and_gradients(family):
    """Rematerialised blocks (``with_cp``) recompute what the plain run
    kept: with drop path on, the same generator gives the same loss and
    gradients, to the last bit of fp32 in another order (rtol 1e-5)."""
    from test_torch_vit import tiny_vit_cfg
    grads = []
    for with_cp in (False, True):
        cfg = tiny_vit_cfg() if family == 'vit' else \
            tiny_cfg(family, drop_path_rate=0.3)
        cfg['backbone']['with_cp'] = with_cp
        model = build_segmentor(cfg).init_weights(
            torch.Generator().manual_seed(0)).train()
        size = 32 if family == 'vit' else SIZE[family]
        img = nchw(_images(np.random.RandomState(3), 2, size))
        gt = torch.from_numpy(np.random.RandomState(4).randint(
            0, 5, (2, size, size)))
        torch.manual_seed(11)
        losses, _ = model.forward_train(img, gt)
        loss = sum(v for k, v in losses.items() if 'loss' in k)
        loss.backward()
        grads.append((loss.item(), {n: p.grad.clone() for n, p in
                                    model.named_parameters()
                                    if p.grad is not None}))
    (loss0, g0), (loss1, g1) = grads
    assert loss0 == pytest.approx(loss1, rel=1e-6)
    assert g0.keys() == g1.keys() and len(g0) > 10
    for name in g0:
        torch.testing.assert_close(g1[name], g0[name], rtol=1e-5, atol=1e-7,
                                   msg=name)


@pytest.mark.parametrize('family', ['beit', 'mae', 'swin'])
def test_layer_decay_and_custom_key_labels_match_jax(family, refs):
    """Each converted parameter's layer-decay depth and ``custom_keys``
    label equal the JAX file's for the same leaf of the JAX tree (labels
    only; no optimizer is built)."""
    variables = refs(family)['variables']
    port = _port(family, variables)
    paths = port_opt.param_paths(port.named_parameters(),
                                 **key_families(port))
    jax_paths = {'/'.join(str(getattr(p, 'key', p)) for p in path)
                 for path, _ in jax.tree_util.tree_leaves_with_path(
                     variables['params'])}
    custom = ('relative_position_bias_table', 'pos_embed', 'cls_token',
              'norm', 'gamma', 'backbone', 'head')
    jax_label, _ = jax_opt._paramwise_mask_fn(
        {'custom_keys': dict.fromkeys(custom, {})})
    depths = set()
    for name, path in paths.items():
        assert path in jax_paths, (name, path)
        for layers in (4, 12):
            want = jax_opt._layer_id_from_path(path, layers)
            assert port_opt._layer_id_from_path(path, layers) == want, path
            depths.add(want)
        assert (port_opt._label_custom_key(path, custom) or '__default__') \
            == jax_label(path), path
    assert len(depths) >= 3
