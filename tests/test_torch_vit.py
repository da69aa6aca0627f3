"""The port's ViT-B/16 UPerNet family against the JAX package's, on the
CPU: the ViT backbone, ``MultiLevelNeck``, ``PPM`` and ``UPerHead``, the
whole segmentor, its weights and initializers, and one supervised SGD
step.

Weights come from ``torch_parity.jax_variables`` (numpy draws in the JAX
layout) and reach the port through ``jax_variables_to_state_dict``. The
configs are ``configs/_base_/models/upernet_vit-b16_ln_mln.py`` cut to
narrow widths and 4 layers (img 32, patch 8: N = 17 tokens). Attention
runs its plain version here; ``chip_smoke.py`` holds the card's kernels
to it. JAX programs with train-mode BN trace under
``two_pass_batch_variance`` (ROADMAP C2).

Tolerances: forward atol 1e-4, rtol 1e-4 (fp32 in another order); the
step's log vars rtol 2e-4, atol 2e-5, post-step parameters rtol 1e-3,
atol 3e-5, BN statistics rtol 2e-3, atol 2e-4 after the n/(n-1) gap of
ROADMAP C2; initializers: standard deviations within 10 % of JAX's own
draws (a few thousand values each).
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

from torch_parity import (FAST_COMPILE, jax_variables, load_port,  # noqa: E402
                          nchw, nhwc, run_jit, two_pass_batch_variance)

from pfst_tpu.apis.train import SupervisedTrainer as JaxTrainer  # noqa: E402
from pfst_tpu.core import optimizers as jax_opt  # noqa: E402
from pfst_tpu.models import build_backbone as jax_build_backbone  # noqa: E402
from pfst_tpu.models import build_head as jax_build_head  # noqa: E402
from pfst_tpu.models import build_neck as jax_build_neck  # noqa: E402
from pfst_tpu.models import build_segmentor as jax_segmentor  # noqa: E402
from pfst_tpu.models.decode_heads import psp_head as jax_psp  # noqa: E402
from pfst_tpu.models.uda.uda_decorator import UDATrainState  # noqa: E402
from pfst_tpu_torch.apis import (build_algorithm, init_segmentor,  # noqa: E402
                                 make_inference_fn)
from pfst_tpu_torch.core import (build_optimizer,  # noqa: E402
                                 jax_variables_to_state_dict,
                                 torch_key_to_flax)
from pfst_tpu_torch.core.convert import key_families  # noqa: E402
from pfst_tpu_torch.models import (build_backbone, build_head,  # noqa: E402
                                   build_neck, build_segmentor)
from pfst_tpu_torch.models.decode_heads import psp_head  # noqa: E402
from pfst_tpu_torch.utils import Config  # noqa: E402

sys.path.insert(0, osp.join(osp.dirname(__file__), '..', 'tools'))
from convert_torch_checkpoint import \
    convert_transformer_state_dict  # noqa: E402

VIT = osp.join(osp.dirname(__file__), '..', 'configs', '_base_', 'models',
               'upernet_vit-b16_ln_mln.py')
TOL = dict(atol=1e-4, rtol=1e-4)
MEAN = [123.675, 116.28, 103.53]
STD = [58.395, 57.12, 57.375]
SGD = dict(type='SGD', lr=1e-2)


def tiny_vit_cfg(img_size=32, embed=32, channels=8):
    """The repo's ViT UPerNet config at narrow widths and 4 layers."""
    cfg = Config.fromfile(VIT).to_dict()['model']
    cfg['backbone'].update(img_size=img_size, patch_size=8,
                           embed_dims=embed, num_layers=4, num_heads=2,
                           out_indices=(0, 1, 2, 3))
    cfg['neck'].update(in_channels=(embed,) * 4, out_channels=16)
    cfg['decode_head'].update(in_channels=(16,) * 4, channels=channels,
                              num_classes=5, dropout_ratio=0.0)
    cfg['auxiliary_head'].update(in_channels=16, channels=channels,
                                 num_classes=5, dropout_ratio=0.0)
    return cfg


def _images(rs, b, size):
    """Normal noise, each image shifted by its own offset (train-mode BN
    of the 1x1 pooled PPM branch normalizes one value per image)."""
    shift = np.linspace(-2.0, 2.0, b).reshape(b, 1, 1, 1)
    return (rs.randn(b, size, size, 3) + shift).astype(np.float32)


def _load(port, variables, prefix, jax_name):
    """JAX ``variables`` of one submodule into ``port`` (keys without the
    segmentor's ``prefix.``)."""
    template = {f'{prefix}.{k}': v for k, v in port.state_dict().items()}
    holder = torch.nn.Module()
    setattr(holder, prefix, port)
    sd = jax_variables_to_state_dict(
        {c: {jax_name: t} for c, t in variables.items()}, template,
        **key_families(holder))
    port.load_state_dict({k[len(prefix) + 1:]: v for k, v in sd.items()})
    return port.eval()


# --------------------------------- backbone ---------------------------------
@pytest.mark.parametrize('size,mode', [(32, 'bicubic'), (48, 'bilinear')])
def test_vit_matches_jax(size, mode):
    """Every output tap within 1e-4; at 48^2 the 4x4 position grid is
    resized to 6x6 (bilinear; the config's bicubic needs no resize at
    its own size)."""
    cfg = dict(tiny_vit_cfg()['backbone'], interpolate_mode=mode)
    jvit = jax_build_backbone(dict(cfg))
    variables = jax_variables(jvit, (1, 32, 32, 3))
    img = _images(np.random.RandomState(0), 2, size)
    ref = run_jit(lambda v, x: jvit.apply(v, x), variables, img)
    port = _load(build_backbone(dict(cfg)), variables, 'backbone',
                 'backbone_mod')
    with torch.no_grad():
        outs = port(nchw(img))
    assert len(outs) == len(ref) == 4
    for got, want in zip(outs, ref):
        np.testing.assert_allclose(nhwc(got), np.asarray(want), **TOL)


def test_vit_bicubic_resize_raises_as_jax():
    cfg = tiny_vit_cfg()['backbone']
    img = np.zeros((1, 48, 48, 3), np.float32)
    jvit = jax_build_backbone(dict(cfg))
    variables = jax_variables(jvit, (1, 32, 32, 3))
    with pytest.raises(ValueError, match='bicubic'):
        jvit.apply(variables, img)
    with pytest.raises(ValueError, match='bicubic'):
        build_backbone(dict(cfg))(nchw(img))


# --------------------------- neck, PPM, UPerHead ---------------------------
def _pyramid(rs, channels, sizes=(16, 8, 4, 2)):
    return [rs.randn(2, s, s, channels).astype(np.float32) for s in sizes]


def test_multilevel_neck_matches_jax():
    cfg = tiny_vit_cfg()['neck']
    jneck = jax_build_neck(dict(cfg))
    feats = [f for f in _pyramid(np.random.RandomState(1), 32, (4,) * 4)]
    variables = jax_variables(jneck, [f.shape for f in feats])
    ref = run_jit(lambda v, x: jneck.apply(v, x), variables, tuple(feats))
    port = _load(build_neck(dict(cfg)), variables, 'neck', 'neck_mod')
    with torch.no_grad():
        outs = port([nchw(f) for f in feats])
    assert [o.shape[-1] for o in outs] == [16, 8, 4, 2]
    for got, want in zip(outs, ref):
        np.testing.assert_allclose(nhwc(got), np.asarray(want), **TOL)


def test_adaptive_pool_and_ppm_match_jax():
    rs = np.random.RandomState(2)
    x = rs.randn(2, 7, 10, 16).astype(np.float32)
    for size in (1, 2, 3, 6):
        np.testing.assert_allclose(
            nhwc(psp_head.adaptive_avg_pool(nchw(x), size)),
            np.asarray(jax_psp.adaptive_avg_pool(jnp.asarray(x), size)),
            atol=1e-6)
    norm = dict(type='BN', requires_grad=True)
    jppm = jax_psp.PPM((1, 2, 3, 6), 8, False, norm)
    variables = jax_variables(jppm, x.shape)
    ref = run_jit(lambda v, t: jppm.apply(v, t), variables, x)
    port = psp_head.PPM((1, 2, 3, 6), 16, 8, False, norm)
    _load_ppm(port, variables)
    with torch.no_grad():
        outs = port(nchw(x))
    for got, want in zip(outs, ref):
        np.testing.assert_allclose(nhwc(got), np.asarray(want), **TOL)


def _load_ppm(port, variables):
    """The PPM's keys as a UPerHead's (``decode_head.psp_modules.*``, the
    JAX file's ``decode_head_mod/ppm``), through ``torch_key_to_flax``."""
    sd = {}
    for key, ref in port.state_dict().items():
        if key.endswith('num_batches_tracked'):
            sd[key] = torch.zeros_like(ref)
            continue
        coll, path = torch_key_to_flax(f'decode_head.psp_modules.{key}',
                                       ref.ndim, uper=True)
        assert path[:2] == ['decode_head_mod', 'ppm']
        leaf = variables[coll]
        for name in path[2:]:
            leaf = leaf[name]
        leaf = np.asarray(leaf)
        sd[key] = torch.from_numpy(np.ascontiguousarray(
            leaf.transpose(3, 2, 0, 1) if leaf.ndim == 4 else leaf))
    port.load_state_dict(sd)
    port.eval()


def test_uper_head_matches_jax():
    cfg = tiny_vit_cfg()['decode_head']
    jhead = jax_build_head(dict(cfg))
    feats = _pyramid(np.random.RandomState(3), 16)
    variables = jax_variables(jhead, [f.shape for f in feats])
    ref_logits, ref_feats = run_jit(lambda v, x: jhead.apply(v, x),
                                    variables, tuple(feats))
    port = _load(build_head(dict(cfg)), variables, 'decode_head',
                 'decode_head_mod')
    with torch.no_grad():
        logits, decoded = port([nchw(f) for f in feats])
    np.testing.assert_allclose(nhwc(logits), np.asarray(ref_logits), **TOL)
    np.testing.assert_allclose(nhwc(decoded), np.asarray(ref_feats), **TOL)


# --------------------------------- segmentor --------------------------------
@pytest.fixture(scope='module')
def pair():
    cfg = tiny_vit_cfg()
    jmodel = jax_segmentor(cfg)
    variables = jax_variables(jmodel, (1, 32, 32, 3))
    return cfg, jmodel, variables, load_port(build_segmentor(cfg), variables)


def test_segmentor_matches_jax(pair):
    _, jmodel, variables, port = pair
    img = _images(np.random.RandomState(4), 2, 32)
    (ref, ref_states), (ref_probs, _) = run_jit(
        lambda v, x: (jmodel.apply(v, x, method=jmodel.encode_decode),
                      jmodel.apply(v, x, method=jmodel.inference)),
        variables, img)
    with torch.no_grad():
        out, states = port.encode_decode(nchw(img))
        probs, _ = port.inference(nchw(img))
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), **TOL)
    np.testing.assert_allclose(nhwc(states['decoded_features']),
                               np.asarray(ref_states['decoded_features']),
                               **TOL)
    np.testing.assert_allclose(nhwc(probs), np.asarray(ref_probs), **TOL)


def test_state_dict_round_trip_under_rsiseg_names(pair, tmp_path):
    cfg, _, variables, port = pair
    sd = port.state_dict()
    for key in ('backbone.patch_embed.projection.weight',
                'backbone.pos_embed', 'backbone.cls_token',
                'backbone.layers.0.ln1.weight',
                'backbone.layers.3.attn.attn.in_proj_weight',
                'backbone.layers.3.attn.attn.in_proj_bias',
                'backbone.layers.0.attn.attn.out_proj.weight',
                'backbone.layers.0.ffn.layers.0.0.weight',
                'backbone.layers.0.ffn.layers.1.bias', 'backbone.ln1.bias',
                'neck.lateral_convs.3.conv.bias', 'neck.convs.0.conv.weight',
                'decode_head.psp_modules.3.1.conv.weight',
                'decode_head.psp_modules.0.1.bn.running_var',
                'decode_head.bottleneck.bn.weight',
                'decode_head.lateral_convs.2.conv.weight',
                'decode_head.fpn_convs.0.bn.bias',
                'decode_head.fpn_bottleneck.conv.weight',
                'decode_head.conv_seg.weight',
                'auxiliary_head.convs.0.conv.weight'):
        assert key in sd, key
    # the JAX package's own converter maps the backbone keys back exactly
    params, _, _ = convert_transformer_state_dict(sd, 'vit')
    want = dict(jax.tree_util.tree_leaves_with_path(
        variables['params']['backbone_mod']))
    got = jax.tree_util.tree_leaves_with_path(params['backbone_mod'])
    assert len(got) == len(want)
    for path, leaf in got:
        np.testing.assert_array_equal(leaf, np.asarray(want[path]),
                                      err_msg=str(path))
    # and a saved state dict serves the same logits
    path = tmp_path / 'vit.pth'
    torch.save(sd, path)
    loaded = init_segmentor(Config(dict(model=cfg)), str(path),
                            device='cpu')
    img = nchw(_images(np.random.RandomState(5), 1, 32))
    torch.testing.assert_close(make_inference_fn(loaded)(img),
                               make_inference_fn(port)(img), rtol=0, atol=0)


def test_jax_variables_to_state_dict_names_missing_keys(pair):
    _, _, variables, port = pair
    cut = {'params': {k: v for k, v in variables['params'].items()
                      if k != 'neck_mod'},
           'batch_stats': variables['batch_stats']}
    with pytest.raises(KeyError, match='neck.lateral_convs.0.conv.weight'):
        jax_variables_to_state_dict(cut, port.state_dict(),
                                    **key_families(port))


def test_init_weights_follow_jax_initializers():
    """The port's draws against JAX ``model.init``'s own, leaf by leaf:
    Dense kernels and the patch embedding lecun-normal (truncated), zero
    biases, LayerNorms at 1 and 0, ``pos_embed`` truncated-normal(0.02),
    ``cls_token`` 0; the neck's convs truncated-normal fan-out."""
    cfg = tiny_vit_cfg(embed=64, channels=16)
    jmodel = jax_segmentor(cfg)
    ref = run_jit(lambda r, x: jmodel.init({'params': r}, x),
                  jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    port = build_segmentor(cfg).init_weights(torch.Generator().manual_seed(0))
    sd = port.state_dict()
    template = {k: torch.zeros_like(v) for k, v in sd.items()}
    want = jax_variables_to_state_dict(jax.tree.map(np.asarray, ref),
                                       template, **key_families(port))
    checked = 0
    for key, value in sd.items():
        if not key.startswith(('backbone.', 'neck.')):
            continue
        got, ref_v = value.float(), want[key].float()
        if ref_v.std() == 0:
            torch.testing.assert_close(got, ref_v, rtol=0, atol=0,
                                       msg=key)
        else:
            ratio = float(got.std() / ref_v.std())
            assert 0.9 < ratio < 1.1, (key, ratio)
            # truncated at 2 sigma on both sides: JAX's draws reach it
            assert float(got.abs().max()) <= 1.06 * float(ref_v.abs().max())
        checked += 1
    # patch embedding, pos_embed, cls_token, final norm: 6; 12 per block;
    # the neck's 8 convs with bias: 16
    assert checked == 6 + 4 * 12 + 16


# --------------------------------- training ---------------------------------
def test_supervised_sgd_step_matches_jax(pair):
    """One SGD step of ``SupervisedTrainer`` against the JAX trainer's, from
    the same weights and batch (dropout 0)."""
    cfg, jmodel, variables, _ = pair
    rs = np.random.RandomState(6)
    img = _images(rs, 2, 32)
    gt = rs.randint(0, 5, (2, 32, 32)).astype(np.int32)
    gt[:, :2] = 255
    batch = {'img': img, 'gt_semantic_seg': gt}
    tx = jax_opt.build_optimizer(SGD)
    jstate = UDATrainState(
        params=variables['params'], batch_stats=variables['batch_stats'],
        ema_params={}, ema_batch_stats={},
        opt_state=tx.init(variables['params']), step=jnp.zeros((), jnp.int32))
    step_fn = JaxTrainer(jmodel).make_train_step(tx, MEAN, STD, jit=False)
    with two_pass_batch_variance():
        compiled = jax.jit(step_fn).lower(jstate, batch, jax.random.PRNGKey(0)
                                          ).compile(FAST_COMPILE)
    new_state, ref_vars, _ = compiled(jstate, batch, jax.random.PRNGKey(0))

    algo = build_algorithm({'model': copy.deepcopy(cfg)}, device='cpu')
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
    for h in hooks:
        h.remove()
    assert state.step == int(new_state.step) == 1
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
            # torch's running variance is unbiased: c = n / (n - 1)
            c = counts[name] / (counts[name] - 1)
            want = c * after[key] - (c - 1) * (1 - m) * before[key]
            tol = dict(rtol=2e-3, atol=2e-4)
        elif leaf == 'running_mean':
            want, tol = after[key], dict(rtol=2e-3, atol=2e-4)
        else:
            want, tol = after[key], dict(rtol=1e-3, atol=3e-5)
        np.testing.assert_allclose(value.numpy(), want.numpy(),
                                   err_msg=key, **tol)
    assert float((template['decode_head.conv_seg.weight']
                  - before['decode_head.conv_seg.weight']).abs().max()) > 0


def test_build_algorithm_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        build_algorithm({'model': tiny_vit_cfg()})
