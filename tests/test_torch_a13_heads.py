"""The port's SETR (naive, PUP, MLA), Segmenter and DPT heads on the ViT,
its PSPNet, Semantic-FPN and ANN heads on the ResNet, and the MLA and FPN
necks, against the JAX package on the CPU.

The nine ``configs/_base_/models`` defs at narrow widths: the ViT 64
wide with 4 heads on 32^2 inputs (patch 8: a 4^2 grid), 4 layers where
the def taps four levels (every layer tapped) and 2 for Segmenter (the
last, through the final norm); DPT's position table at a 2^2 grid,
resized to the 4^2 one on every forward as the def's 224 is to a 512^2
request's; the ResNets at depth 18 with 8 stem and base channels on
64^2 inputs (PSPNet's 14 bands and its 2 weighted classes kept); heads
at 8-32 channels and 5 classes. Weights come from
``torch_parity.jax_variables`` through ``jax_variables_to_state_dict``,
which must fill every key, three and four auxiliary heads included. One
JAX program a def computes the backbone's taps, the neck's outputs, the
heads' logits and features and the segmentor's logits, shared by the
tests (and across xdist's workers) through
``torch_parity.shared_by_workers``; each module is held on the JAX
program's own inputs to it, each segmentor on the image. Segmenter's
attention runs its plain version here; ``chip_smoke.py`` holds the
card's kernels to it.

Tolerances: ``test_torch_transformers.py``'s. Forward atol 1e-4, rtol
1e-4 (fp32 in another order); the step's log vars rtol 2e-4, atol 2e-5,
post-step parameters rtol 1e-3, atol 3e-5, BN statistics rtol 2e-3,
atol 2e-4 after the n/(n-1) gap of ROADMAP C2.
"""
import copy
import importlib
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
from pfst_tpu.models import build_neck as jax_build_neck  # noqa: E402
from pfst_tpu.models import build_segmentor as jax_segmentor  # noqa: E402
from pfst_tpu.models.uda.uda_decorator import UDATrainState  # noqa: E402
from pfst_tpu_torch.apis import build_algorithm  # noqa: E402
from pfst_tpu_torch.core import (build_optimizer,  # noqa: E402
                                 jax_variables_to_state_dict)
from pfst_tpu_torch.core.convert import (key_families,  # noqa: E402
                                         torch_key_to_flax)
from pfst_tpu_torch.models import build_neck, build_segmentor  # noqa: E402
from pfst_tpu_torch.utils import Config  # noqa: E402

# the module (``pfst_tpu_torch.ops.attention`` is also its function's name)
attn_mod = importlib.import_module('pfst_tpu_torch.ops.attention')
CONFIGS = osp.join(osp.dirname(__file__), '..', 'configs', '_base_',
                   'models')
TOL = dict(atol=1e-4, rtol=1e-4)
SGD = dict(type='SGD', lr=1e-2)
DEFS = ['setr_naive', 'setr_pup', 'setr_mla', 'segmenter_vit-b16_mask',
        'dpt_vit-b16', 'pspnet_r50-d8', 'fpn_r50', 'ann_r50-d8',
        'annnet_r50-d8']
VIT_HW, RESNET_HW = 32, 64
RESNET_CHANS = (8, 16, 32, 64)


def _head(cfg, **kw):
    cfg.update(kw)
    cfg['dropout_ratio'] = 0.0
    if cfg.get('num_classes') != 2:
        cfg['num_classes'] = 5
    return cfg


def tiny_cfg(name):
    """A def of ``DEFS`` at narrow widths (module docstring)."""
    cfg = Config.fromfile(osp.join(CONFIGS, f'{name}.py')).to_dict()['model']
    bb, aux = cfg['backbone'], cfg.get('auxiliary_head')
    if bb['type'] == 'VisionTransformer':
        four = len(bb['out_indices']) == 4
        bb.update(img_size=16 if name == 'dpt_vit-b16' else VIT_HW,
                  patch_size=8, embed_dims=64, num_heads=4,
                  num_layers=4 if four else 2,
                  out_indices=(0, 1, 2, 3) if four else (1,))
    else:
        bb.update(depth=18, base_channels=8, stem_channels=8)
    head = cfg['decode_head']
    if name in ('setr_naive', 'setr_pup'):
        _head(head, in_channels=64, channels=16)
        for a in aux:
            _head(a, in_channels=64, channels=16)
    elif name == 'setr_mla':
        cfg['neck'].update(in_channels=(64,) * 4, out_channels=16)
        _head(head, in_channels=(16,) * 4, channels=32, mla_channels=8)
        for a in aux:
            _head(a, in_channels=16, channels=16)
    elif name == 'segmenter_vit-b16_mask':
        _head(head, in_channels=64, channels=64, embed_dims=64, num_heads=4)
    elif name == 'dpt_vit-b16':
        _head(head, in_channels=(64,) * 4, channels=16, embed_dims=64,
              post_process_channels=(8, 16, 32, 64))
    elif name == 'fpn_r50':
        cfg['neck'].update(in_channels=RESNET_CHANS, out_channels=16)
        _head(head, in_channels=(16,) * 4, channels=8)
    else:
        _head(head, in_channels=RESNET_CHANS[3] if name == 'pspnet_r50-d8'
              else RESNET_CHANS[2:], channels=16)
        _head(aux, in_channels=RESNET_CHANS[2], channels=8)
    return cfg


def _bands(name):
    return 14 if name == 'pspnet_r50-d8' else 3


def _size(name):
    return VIT_HW if name in DEFS[:5] else RESNET_HW


def _images(rs, b, size, bands=3):
    """Normal noise, each image shifted by its own offset (train-mode BN
    of a pooled branch normalizes one value per image)."""
    shift = np.linspace(-2.0, 2.0, b).reshape(b, 1, 1, 1)
    return (rs.randn(b, size, size, bands) + shift).astype(np.float32)


def _jax_reference(name):
    """The JAX model's variables, and on two seeded images its backbone
    taps, neck outputs, head logits and features, auxiliary logits and the
    segmentor's logits (numpy)."""
    jmodel = jax_segmentor(copy.deepcopy(tiny_cfg(name)))
    size, bands = _size(name), _bands(name)
    variables = jax_variables(jmodel, (1, size, size, bands))
    img = _images(np.random.RandomState(4), 2, size, bands)

    def run(v, x):
        taps = jmodel.apply(v, x, method=lambda m, t: m.backbone_mod(t))
        out = jmodel.apply(v, x)
        logits, _ = jmodel.apply(v, x, method=jmodel.encode_decode)
        return dict(taps=taps, feats=out['feats'],
                    head_logits=out['seg_logits'],
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
                tmp_path_factory, f'a13_heads_{name}',
                lambda: _jax_reference(name))
        return cache[name]
    return get


def _port(name, variables):
    return load_port(build_segmentor(tiny_cfg(name)), variables)


def _close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(nhwc(g), w, **TOL)


# ------------------------------ the modules ------------------------------
@pytest.mark.parametrize('name, part', [
    ('setr_naive', 'decode_head'),         # SETRUPHead, LN ConvModule
    ('setr_pup', 'decode_head'),           # SETRUPHead, BN, 4 stages
    ('setr_mla', 'neck'),                  # MLANeck
    ('setr_mla', 'decode_head'),           # SETRMLAHead
    ('segmenter_vit-b16_mask', 'decode_head'),
    ('dpt_vit-b16', 'decode_head'),        # DPTHead
    ('pspnet_r50-d8', 'decode_head'),      # PSPHead
    ('fpn_r50', 'neck'),                   # FPN
    ('fpn_r50', 'decode_head'),            # FPNHead
    ('ann_r50-d8', 'decode_head')])        # ANNHead
def test_module_matches_jax(name, part, refs):
    """The module on the JAX program's own inputs to it: a neck on the
    backbone's taps, a head on the neck's outputs (or the taps); its
    outputs within 1e-4 of the JAX module's."""
    r = refs(name)
    port = _port(name, r['variables'])
    out = r['out']
    with torch.no_grad():
        if part == 'neck':
            _close(port.neck([nchw(t) for t in out['taps']]), out['feats'])
            return
        logits, decoded = port.decode_head([nchw(f) for f in out['feats']])
    _close([logits, decoded], [out['head_logits'], out['decoded']])


@pytest.mark.parametrize('name', DEFS)
def test_segmentor_matches_jax(name, refs):
    """The def's segmentor from its config: every key filled from the JAX
    tree, and its taps, neck outputs, head logits and features, every
    auxiliary head's logits and the resized logits within 1e-4."""
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
    _close([out['seg_logits'], out['decoded_features'], logits],
           [want['head_logits'], want['decoded'], want['logits']])
    _close(out['aux_logits'], want['aux_logits'])
    assert states['decoded_features'].shape == out['decoded_features'].shape


def test_auxiliary_head_lists_and_neck_families_map_by_class(refs):
    """A list of auxiliary heads maps head i to the JAX file's
    ``aux_heads_{i}`` (three for SETR-PUP, four for SETR-MLA); the neck's
    key map is the one its class declares, and a neck key read with
    another neck's map has no source."""
    pup = _port('setr_pup', refs('setr_pup')['variables'])
    keys = [k for k in pup.state_dict() if k.startswith('auxiliary_head.')]
    assert {k.split('.')[1] for k in keys} == {'0', '1', '2'}
    assert torch_key_to_flax('auxiliary_head.2.up_convs.0.0.bn.weight',
                             1) == ('params', ['aux_heads_2', 'up_conv0',
                                               'norm', 'bn', 'scale'])
    mla = _port('setr_mla', refs('setr_mla')['variables'])
    assert key_families(mla) == {'neck': 'mla'}
    assert len({k.split('.')[1] for k in mla.state_dict()
                if k.startswith('auxiliary_head.')}) == 4
    assert torch_key_to_flax('neck.lateral.1.conv.weight', 4, neck='mla') \
        == ('params', ['neck_mod', 'lateral1', 'conv', 'kernel'])
    assert torch_key_to_flax('neck.lateral.1.conv.weight', 4,
                             neck='fpn') is None
    fpn = _port('fpn_r50', refs('fpn_r50')['variables'])
    assert key_families(fpn) == {'neck': 'fpn'}
    assert torch_key_to_flax('neck.fpn_convs.3.conv.bias', 1, neck='fpn') \
        == ('params', ['neck_mod', 'fpn_conv3', 'conv', 'bias'])
    with pytest.raises(KeyError, match='neck.fpn_convs'):
        jax_variables_to_state_dict(refs('fpn_r50')['variables'],
                                    fpn.state_dict(), neck='multilevel')


def test_fpn_extra_outputs_match_jax():
    """``num_outs`` past the levels: each extra output a 1x1 max pool with
    stride 2 of the last, on odd sizes too (the ``fpn_r50`` def does not
    reach them)."""
    cfg = dict(type='FPN', in_channels=(4, 8, 16), out_channels=8,
               num_outs=5)
    rs = np.random.RandomState(2)
    feats = tuple(rs.randn(2, s, s, c).astype(np.float32)
                  for s, c in ((13, 4), (7, 8), (4, 16)))
    jneck = jax_build_neck(dict(cfg))
    variables = jax_variables(jneck, [f.shape for f in feats])
    ref = run_jit(lambda v, x: jneck.apply(v, x), variables, feats)
    holder = torch.nn.Module()
    holder.neck = build_neck(dict(cfg))
    load_port(holder, {'params': {'neck_mod': variables['params']}})
    with torch.no_grad():
        outs = holder.neck([nchw(f) for f in feats])
    assert [o.shape[-1] for o in outs] == [13, 7, 4, 2, 1]
    _close(outs, [np.asarray(x) for x in ref])


# ------------------------- Segmenter on the card -------------------------
class _CudaView(torch.Tensor):
    """A CPU tensor that reports the card as its device, so that the
    attention's dispatch takes the path of a CUDA tensor."""

    @property
    def device(self):
        return torch.device('cuda')


def test_segmenter_attention_on_cuda_tensors_never_reaches_the_plain_version(
        monkeypatch, refs):
    """On tensors of the card, each of the Segmenter head's decoder layers
    hands its (B, heads, N, d) views of one (B, N, 3, heads, d) projection
    (N = patches + class tokens) to the flash kernels' autograd Function;
    the plain versions, made to raise, are never reached. The Function,
    stubbed here with the plain formula, gives the CPU head's output."""
    r = refs('segmenter_vit-b16_mask')
    head = _port('segmenter_vit-b16_mask', r['variables']).decode_head
    feats = [nchw(f) for f in r['out']['feats']]
    with torch.no_grad():
        want = head(feats)
    plain = attn_mod.torch_attention
    calls = []

    def kernels(q, k, v, ab, scale):
        calls.append((tuple(q.shape), q.stride(), k.stride(), v.stride(),
                      ab, scale))
        return plain(*(t.as_subclass(torch.Tensor) for t in (q, k, v)),
                     scale).as_subclass(_CudaView)

    def refuse(*args, **kwargs):
        raise AssertionError('a CUDA tensor reached the plain version')
    monkeypatch.setattr(attn_mod._FlashAttention, 'apply', kernels)
    monkeypatch.setattr(attn_mod, 'torch_attention', refuse)
    monkeypatch.setattr(attn_mod, 'torch_attention_backward', refuse)
    with torch.no_grad():
        got = head([f.as_subclass(_CudaView) for f in feats])
    b, c, h, w = feats[-1].shape
    n, hd = h * w + 5, 64 // 4
    strides = (n * 3 * 64, hd, 3 * 64, 1)
    assert calls == [((b, 4, n, hd), strides, strides, strides, None,
                      hd**-0.5)] * 2
    for g, want_t in zip(got, want):
        torch.testing.assert_close(g.as_subclass(torch.Tensor), want_t,
                                   rtol=0, atol=0)


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


@pytest.mark.parametrize('name', ['segmenter_vit-b16_mask', 'setr_pup',
                                  'ann_r50-d8'])
def test_supervised_sgd_step_matches_jax(name):
    """One SGD step of ``SupervisedTrainer`` against the JAX trainer's
    from the same weights and batch: log vars (three auxiliary losses for
    SETR-PUP) and every parameter and BN statistic after the step."""
    size = _size(name)
    variables = jax_variables(jax_segmentor(tiny_cfg(name)),
                              (1, size, size, 3))
    rs = np.random.RandomState(6)
    img = _images(rs, 2, size)
    gt = rs.randint(0, 5, (2, size, size)).astype(np.int32)
    gt[:, :2] = 255
    mean, std = [120.0, 110.0, 100.0], [60.0, 55.0, 58.0]
    new_state, ref_vars = _jax_step(name, variables,
                                    {'img': img, 'gt_semantic_seg': gt},
                                    mean, std)
    algo = build_algorithm({'model': tiny_cfg(name)}, device='cpu')
    state = algo.init_state(torch.Generator().manual_seed(0),
                            build_optimizer(SGD))
    load_port(state.student, variables).train()
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
    assert sorted(got) == sorted(ref_vars)
    if name == 'setr_pup':
        assert {'aux_0.loss_ce', 'aux_2.loss_ce'} <= set(got)
    for k in ref_vars:
        np.testing.assert_allclose(got[k].item(), float(ref_vars[k]),
                                   rtol=2e-4, atol=2e-5, err_msg=k)
    template = state.student.state_dict()
    families = key_families(state.student)
    before = jax_variables_to_state_dict(variables, template, **families)
    after = jax_variables_to_state_dict(
        {'params': new_state.params, 'batch_stats': new_state.batch_stats},
        template, **families)
    m, moved = 0.1, 0
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
            moved += bool((value - before[key]).abs().max() > 0)
        np.testing.assert_allclose(value.numpy(), want.numpy(),
                                   err_msg=key, **tol)
    assert moved > 10
