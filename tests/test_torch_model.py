"""Parity of the port's models (``pfst_tpu_torch.models``) with the JAX
ones, on the same weights: drawn from a numpy seed in the JAX layout and
carried into the port with ``jax_variables_to_state_dict``.

Two configs: ``tiny_model_cfg`` (ResNetV1c-18 + DeepLabV3+) and a narrow
ResNetV1c-50 (Bottleneck + contract_dilation) with the same head. Each
JAX model and its weights are built once per module. Tolerance: atol
1e-4, rtol 1e-4 (fp32 convolutions summed in another order through up
to 50 layers).
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

from conftest import tiny_model_cfg  # noqa: E402
from torch_parity import (jax_variables, load_port, nchw, nhwc,  # noqa: E402
                          run_jit)

from pfst_tpu.models import build_backbone as jax_build_backbone  # noqa: E402
from pfst_tpu.models import build_segmentor as jax_segmentor  # noqa: E402
from pfst_tpu.models.utils import layers as jax_layers  # noqa: E402
from pfst_tpu_torch.apis import init_segmentor  # noqa: E402
from pfst_tpu_torch.core import jax_variables_to_state_dict  # noqa: E402
from pfst_tpu_torch.models import build_backbone, build_segmentor  # noqa: E402
from pfst_tpu_torch.models.utils import layers  # noqa: E402
from pfst_tpu_torch.utils import Config  # noqa: E402

sys.path.insert(0, osp.join(osp.dirname(__file__), '..', 'tools'))
from convert_torch_checkpoint import convert_state_dict  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)


def narrow_r50_cfg():
    cfg = tiny_model_cfg(depth=50)
    # Bottleneck stages at base 8: layer1..4 give 32/64/128/256 channels
    cfg['decode_head'].update(in_channels=256, c1_in_channels=32)
    cfg['auxiliary_head'].update(in_channels=128)
    return cfg


CFGS = {'tiny': tiny_model_cfg, 'r50': narrow_r50_cfg}


@pytest.fixture(scope='module', params=sorted(CFGS))
def pair(request):
    """(cfg, JAX model, JAX variables, port model) for one config."""
    cfg = CFGS[request.param]()
    jmodel = jax_segmentor(cfg)
    variables = jax_variables(jmodel, (1, 64, 64, 3))
    port = load_port(build_segmentor(cfg), variables)
    return cfg, jmodel, variables, port


def _img(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_encode_decode_matches_jax(pair):
    _, jmodel, variables, port = pair
    x = _img((2, 48, 64, 3))
    ref_out, ref_st = run_jit(lambda v, img: jmodel.apply(
        v, img, method=jmodel.encode_decode), variables, jnp.asarray(x))
    with torch.no_grad():
        out, states = port.encode_decode(nchw(x))
        fwd = port(nchw(x))
    assert out.shape == (2, 6, 48, 64)
    np.testing.assert_allclose(nhwc(out), ref_out, **TOL)
    for key in ('decoded_features', 'head_logits'):
        np.testing.assert_allclose(nhwc(states[key]), ref_st[key], **TOL)
    for f, rf in zip(states['feats'], ref_st['feats'], strict=True):
        np.testing.assert_allclose(nhwc(f), rf, **TOL)
    # the full forward runs the same decode path plus the auxiliary head
    assert torch.equal(fwd['seg_logits'], states['head_logits'])
    assert fwd['aux_logits'][0].shape == (2, 6, 6, 8)


def test_slide_inference_matches_jax(pair):
    cfg, _, variables, port = pair
    test_cfg = dict(mode='slide', crop_size=(32, 32), stride=(24, 20))
    jmodel = jax_segmentor({**cfg, 'test_cfg': test_cfg})
    x = _img((1, 40, 56, 3), seed=1)
    ref = run_jit(lambda v, img: jmodel.apply(
        v, img, method=jmodel.inference_logits)[0], variables,
        jnp.asarray(x))
    port.test_cfg = test_cfg
    try:
        with torch.no_grad():
            out, _ = port.inference_logits(nchw(x))
    finally:
        port.test_cfg = cfg['test_cfg']
    np.testing.assert_allclose(nhwc(out), ref, **TOL)


def test_inference_rescale_flip_matches_jax(pair):
    _, jmodel, variables, port = pair
    x = _img((1, 32, 48, 3), seed=2)
    kw = dict(rescale_size=(45, 61), flip=True,
              flip_direction=['horizontal', 'vertical'])
    ref = run_jit(lambda v, img: jmodel.apply(
        v, img, method=jmodel.inference, **kw)[0], variables,
        jnp.asarray(x))
    with torch.no_grad():
        probs, _ = port.inference(nchw(x), **kw)
        labels, probs2, _ = port.simple_test_logits(nchw(x))
    np.testing.assert_allclose(nhwc(probs), ref, atol=1e-5, rtol=0)
    assert torch.equal(labels, probs2.argmax(dim=1))


def test_state_dict_round_trip(pair):
    """port state_dict -> the tools converter -> the JAX tree, leaf by
    leaf and with nothing left over on either side."""
    _, _, variables, port = pair
    params, batch_stats, skipped = convert_state_dict(port.state_dict())
    assert all(k.endswith('num_batches_tracked') for k in skipped), skipped
    for coll, tree in (('params', params), ('batch_stats', batch_stats)):
        ref = jax.tree_util.tree_leaves_with_path(variables[coll])
        got = dict(jax.tree_util.tree_leaves_with_path(tree))
        assert len(got) == len(ref)
        for path, leaf in ref:
            np.testing.assert_array_equal(got[path], leaf, err_msg=str(path))


def test_missing_source_names_the_key(pair):
    _, _, variables, port = pair
    cut = copy.deepcopy(variables)
    del cut['params']['decode_head_mod']['bottleneck']['conv']
    with pytest.raises(KeyError, match='decode_head.bottleneck.conv.weight'):
        jax_variables_to_state_dict(cut, port.state_dict())


@pytest.mark.parametrize('prefix', ['', 'model.'])
def test_init_segmentor_loads_checkpoint(pair, tmp_path, prefix):
    cfg, _, _, port = pair
    sd = {prefix + k: v for k, v in port.state_dict().items()}
    if prefix:   # a UDA checkpoint also holds the teacher
        sd.update({'ema_model.' + k: torch.zeros_like(v)
                   for k, v in port.state_dict().items()})
    path = str(tmp_path / 'ckpt.pth')
    torch.save({'state_dict': sd, 'meta': {}}, path)
    model = init_segmentor(Config(dict(model=cfg)), path, device='cpu')
    assert not model.training
    for k, v in port.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k


@pytest.mark.parametrize('backbone', [
    dict(type='ResNetV1d', depth=50, multi_grid=(1, 2, 4)),
    dict(type='ResNet', depth=18, strides=(1, 2, 2, 1),
         dilations=(1, 1, 1, 2))])
def test_backbone_variants_match_jax(backbone):
    cfg = dict(base_channels=8, stem_channels=8, num_stages=4,
               out_indices=(0, 1, 2, 3), strides=(1, 2, 1, 1),
               dilations=(1, 1, 2, 4), contract_dilation=True,
               norm_cfg=dict(type='BN'))
    cfg.update(backbone)
    jmodel = jax_build_backbone(cfg)
    x = _img((1, 32, 40, 3), seed=3)
    bb_vars = jax_variables(jmodel, (1, 32, 32, 3))
    variables = {c: {'backbone_mod': t} for c, t in bb_vars.items()}
    port = build_backbone(cfg)
    template = {'backbone.' + k: v for k, v in port.state_dict().items()}
    sd = jax_variables_to_state_dict(variables, template)
    port.load_state_dict({k[len('backbone.'):]: v for k, v in sd.items()})
    port.eval()
    refs = run_jit(jmodel.apply, bb_vars, jnp.asarray(x))
    with torch.no_grad():
        outs = port(nchw(x))
    assert len(outs) == len(refs) == 4
    for o, r in zip(outs, refs):
        np.testing.assert_allclose(nhwc(o), r, **TOL)


@pytest.mark.parametrize('norm_cfg,act_cfg', [
    (dict(type='BN'), None),
    (dict(type='SyncBN'), dict(type='ReLU6')),
    (dict(type='GN', num_groups=4), dict(type='GELU')),
    (dict(type='LN'), dict(type='SiLU')),
    (dict(type='IN'), dict(type='LeakyReLU', negative_slope=0.2)),
    (None, dict(type='HSwish')),
    (dict(type='BN'), dict(type='none'))])
def test_conv_module_matches_jax(norm_cfg, act_cfg):
    kw = dict(kernel_size=3, padding=2, dilation=2, norm_cfg=norm_cfg,
              act_cfg=act_cfg)
    jmod = jax_layers.ConvModule(8, **kw)
    x = _img((2, 9, 10, 4), seed=4)
    variables = jax_variables(jmod, x.shape)
    port = layers.ConvModule(4, 8, **kw).eval()
    p = variables['params']
    sd = {'conv.weight': p['conv']['kernel'].transpose(3, 2, 0, 1)}
    if 'bias' in p['conv']:
        sd['conv.bias'] = p['conv']['bias']
    if norm_cfg is not None:
        name = port.norm_name
        (norm,) = p['norm'].values()
        sd[f'{name}.weight'], sd[f'{name}.bias'] = norm['scale'], norm['bias']
        if name == 'bn':
            stats = variables['batch_stats']['norm']['bn']
            sd['bn.running_mean'], sd['bn.running_var'] = stats['mean'], \
                stats['var']
    port.load_state_dict({k: torch.from_numpy(np.asarray(v))
                          for k, v in sd.items()}, strict=False)
    ref = jmod.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        out = port(nchw(x))
    np.testing.assert_allclose(nhwc(out), ref, atol=1e-5, rtol=1e-5)


def test_init_weights_follow_jax_initializers():
    """Convs: flax's variance_scaling(2.0, 'fan_out', 'truncated_normal'),
    i.e. std sqrt(2 / fan_out) truncated at two (pre-truncation) stds;
    the classifier: normal(0.01); biases zero; seeded by the generator."""
    cfg = narrow_r50_cfg()
    a = build_segmentor(cfg).init_weights(torch.Generator().manual_seed(3))
    b = build_segmentor(cfg).init_weights(torch.Generator().manual_seed(3))
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k
    with torch.no_grad():
        w = a.decode_head.bottleneck.conv.weight     # 3x3, 80 -> 16
        std = np.sqrt(2.0 / (16 * 9))
        assert abs(float(w.std()) / std - 1) < 0.05
        assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
        seg = a.decode_head.conv_seg
        assert abs(float(seg.weight.std()) - 0.01) < 0.002
        assert float(seg.bias.abs().max()) == 0.0


def test_bfloat16_dtype_runs_under_autocast():
    cfg = dict(tiny_model_cfg(), dtype='bfloat16')
    model = build_segmentor(cfg).eval()
    assert model.dtype == torch.bfloat16
    with torch.no_grad():
        out, states = model.encode_decode(torch.randn(1, 3, 32, 32))
    assert out.dtype == torch.bfloat16
    assert states['decoded_features'].dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_norm_eval_and_frozen_stages_keep_bn_in_eval():
    cfg = dict(type='ResNetV1c', depth=18, base_channels=8,
               stem_channels=8, norm_cfg=dict(type='BN'), frozen_stages=1)
    bb = build_backbone(cfg).train()
    assert not bb.stem[1].training and not bb.layer1[0].bn1.training
    assert bb.layer2[0].bn1.training
    assert not any(p.requires_grad for p in bb.layer1.parameters())
    bb = build_backbone({**cfg, 'frozen_stages': -1,
                         'norm_eval': True}).train()
    assert not any(m.training for m in bb.modules()
                   if isinstance(m, torch.nn.BatchNorm2d))
