"""The port's CNN backbones (UNet, HRNet, ConvNeXt, MobileNetV2/V3,
Fast-SCNN, CGNet, ERFNet, BiSeNetV1/V2, ICNet), the LR-ASPP and
depthwise-separable FCN heads and ``ICNeck`` against the JAX package on
the CPU.

The twelve ``configs/_base_/models`` defs at narrow widths: UNet with
base 8 and 3 stages on 36^2 inputs (max-pooled to 18^2 and 9^2); HRNet
with one block a branch, 4-16 wide, 2 then 3 branches (the first
transition narrows the 16 channels of stage 1's bottlenecks), on 48^2;
ConvNeXt with depths (1, 1, 1, 1) and dims (8, 16, 32, 64) on 36^2
(9^2 after the stem: the downsample convs pad as flax's ``SAME`` does);
MobileNetV3 ``small``; the fast nets at 8-32 channels, BiSeNetV1
and ICNet with an R18 context or backbone of 8 base channels, ICNet on
67^2 inputs (its half-scale branch rounds 33.5 down); heads at 8
channels and 5 classes (CGNet's 19, for its class weights). The heads
keep the widths their configs declare, so each is built at the width it
is fed (``encoder_decoder._at_fed_width``): CGNet's and ICNet's decode
heads and BiSeNetV2's auxiliary heads are declared wider than they are
fed. MobileNetV2, which no def names, is held alone at widen factor
0.25. Weights come from ``torch_parity.jax_variables`` through
``jax_variables_to_state_dict``, which must fill every key. One JAX
program a def computes the backbone's taps, the neck's outputs, the
heads' logits and features, the segmentor's logits and the outputs of
the modules held alone (``capture_intermediates``), shared by the tests
and across xdist's workers through ``torch_parity.shared_by_workers``;
each module is held on the JAX program's own input to it, each
segmentor on the image.

At the configs' full widths, the port's state dict (built on the meta
device) is held key for key to the JAX tree's shapes (``jax.eval_shape``
of ``init``; nothing compiles), and every JAX leaf has a key.

Tolerances: ``test_torch_a13_heads.py``'s. Forward atol 1e-4, rtol 1e-4
(fp32 in another order); the step's log vars rtol 2e-4, atol 2e-5,
post-step parameters rtol 1e-3, atol 3e-5, BN statistics rtol 2e-3,
atol 2e-4 after the n/(n-1) gap of ROADMAP C2.
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
from pfst_tpu.models import build_backbone as jax_backbone  # noqa: E402
from pfst_tpu.models import build_segmentor as jax_segmentor  # noqa: E402
from pfst_tpu.models.uda.uda_decorator import UDATrainState  # noqa: E402
from pfst_tpu.ops import resize as jax_resize  # noqa: E402
from pfst_tpu_torch.apis import build_algorithm  # noqa: E402
from pfst_tpu_torch.core import (build_optimizer,  # noqa: E402
                                 jax_variables_to_state_dict, param_paths)
from pfst_tpu_torch.core.convert import (head_prefix,  # noqa: E402
                                         key_families, lraspp_heads,
                                         torch_key_to_flax, uper_heads)
from pfst_tpu_torch.models import build_backbone, build_segmentor  # noqa: E402
from pfst_tpu_torch.utils import Config  # noqa: E402

CONFIGS = osp.join(osp.dirname(__file__), '..', 'configs', '_base_',
                   'models')
TOL = dict(atol=1e-4, rtol=1e-4)
SGD = dict(type='SGD', lr=1e-2)
DEFS = ['fcn_unet_s5-d16', 'deeplabv3_unet_s5-d16', 'pspnet_unet_s5-d16',
        'fcn_hr18', 'upernet_convnext', 'lraspp_m-v3-d8', 'fast_scnn',
        'cgnet', 'erfnet_fcn', 'bisenetv1_r18-d32', 'bisenetv2',
        'icnet_r50-d8']
SIZE = {'fcn_unet_s5-d16': 36, 'deeplabv3_unet_s5-d16': 36,
        'pspnet_unet_s5-d16': 36, 'fcn_hr18': 48, 'upernet_convnext': 36,
        'icnet_r50-d8': 67, 'mobilenet_v2': 64}
UNET = dict(base_channels=8, num_stages=3, strides=(1, 1, 1),
            enc_num_convs=(2, 2, 2), dec_num_convs=(2, 2),
            downsamples=(True, True), enc_dilations=(1, 1, 1),
            dec_dilations=(1, 1))
HRNET = dict(extra=dict(
    stage1=dict(num_modules=1, num_branches=1, block='BOTTLENECK',
                num_blocks=(1,), num_channels=(4,)),
    stage2=dict(num_modules=1, num_branches=2, block='BASIC',
                num_blocks=(1, 1), num_channels=(4, 8)),
    stage3=dict(num_modules=1, num_branches=3, block='BASIC',
                num_blocks=(1, 1, 1), num_channels=(4, 8, 16)),
    stage4=dict(num_modules=1, num_branches=3, block='BASIC',
                num_blocks=(1, 1, 1), num_channels=(4, 8, 16))))
R18 = dict(depth=18, base_channels=8, stem_channels=8)
BACKBONES = {
    'fcn_hr18': HRNET,
    'upernet_convnext': dict(arch=dict(depths=(1, 1, 1, 1),
                                       dims=(8, 16, 32, 64)),
                             drop_path_rate=0.0),
    'lraspp_m-v3-d8': dict(arch='small'),
    'fast_scnn': dict(downsample_dw_channels=(8, 12), global_in_channels=16,
                      global_block_channels=(16, 24, 32),
                      global_out_channels=32, fusion_out_channels=32),
    'cgnet': dict(num_channels=(8, 16, 32), num_blocks=(2, 3)),
    'erfnet_fcn': dict(enc_downsample_channels=(8, 16, 32),
                       enc_stage_non_bottlenecks=(2, 2)),
    'bisenetv1_r18-d32': dict(context_channels=(16, 32, 64),
                              spatial_channels=(8, 8, 8, 16),
                              out_channels=32),
    'bisenetv2': dict(detail_channels=(8, 8, 16),
                      semantic_channels=(8, 8, 16, 32), bga_channels=16),
    'icnet_r50-d8': dict(light_branch_middle_channels=8, psp_out_channels=16,
                         out_channels=(8, 16, 16)),
}
MOBILENET_V2 = dict(type='MobileNetV2', widen_factor=0.25,
                    norm_cfg=dict(type='BN', requires_grad=True))
# modules held alone: (def, module path in the backbone, path of the
# module whose output is its input)
MODULES = [('fcn_hr18', 'stage4_module0', 'stage3_module0'),
           ('upernet_convnext', 'stage1_block0', 'down_conv1'),
           ('mobilenet_v2', 'layer2_block1', 'layer2_block0'),
           ('cgnet', 'stage1_block1', 'stage1_block0'),
           ('fast_scnn', 'gfe1_0', 'gfe0_2'),
           ('bisenetv2', 'sem1_0', 'sem0_1')]


def _head(cfg, **kw):
    cfg.update(kw, dropout_ratio=0.0)
    if cfg['num_classes'] != 2 and 'class_weight' not in cfg['loss_decode']:
        cfg['num_classes'] = 5
    return cfg


def tiny_cfg(name):
    """A def of ``DEFS`` at narrow widths (module docstring); the heads
    keep their declared ``in_channels``."""
    cfg = Config.fromfile(osp.join(CONFIGS, f'{name}.py')).to_dict()['model']
    bb = cfg['backbone']
    aux = cfg.get('auxiliary_head') or []
    aux = aux if isinstance(aux, list) else [aux]
    if bb['type'] == 'UNet':
        bb.update(UNET)
        _head(cfg['decode_head'], in_index=2, channels=8)
        for a in aux:
            _head(a, in_index=1, channels=8)
        return cfg
    bb.update(BACKBONES[name])
    if 'backbone_cfg' in bb:
        bb['backbone_cfg'].update(R18)
    if name == 'icnet_r50-d8':
        cfg['neck'].update(out_channels=8)
    kw = {'lraspp_m-v3-d8': dict(branch_channels=(4, 8)),
          'fcn_hr18': dict(in_index=(0, 1, 2))}.get(name, {})
    _head(cfg['decode_head'], channels=8, **kw)
    for a in aux:
        _head(a, channels=8)
    return cfg


def _images(rs, b, size):
    """Normal noise, each image shifted by its own offset (train-mode BN
    of a pooled branch normalizes one value per image)."""
    shift = np.linspace(-2.0, 2.0, b).reshape(b, 1, 1, 1)
    return (rs.randn(b, size, size, 3) + shift).astype(np.float32)


def _captured(inter, prefix, paths):
    """The first call's output of each module of ``paths`` under
    ``prefix`` in a ``capture_intermediates`` tree (numpy)."""
    out = {}
    for path in paths:
        node = inter
        for k in [*prefix, *path.split('/')]:
            node = node[k]
        out[path] = jax.tree.map(np.asarray, node['__call__'][0])
    return out


def _jax_reference(name):
    """The JAX model's variables, and on two seeded images its backbone
    taps, neck outputs, head logits and features, auxiliary logits, the
    segmentor's logits and the outputs of the modules of ``MODULES``
    (numpy)."""
    size = SIZE.get(name, 64)
    img = _images(np.random.RandomState(4), 2, size)
    paths = [p for n, m, i in MODULES if n == name for p in (m, i)]
    prefix = [] if name == 'mobilenet_v2' else ['backbone_mod']
    wanted = {'/'.join(prefix + p.split('/')) for p in paths} | {
        'backbone_mod'}

    def keep(module, method):
        return method == '__call__' and '/'.join(module.scope.path) in wanted

    if name == 'mobilenet_v2':
        jmodel = jax_backbone(dict(MOBILENET_V2))
        variables = jax_variables(jmodel, (1, size, size, 3))

        def run(v, x):
            taps, inter = jmodel.apply(v, x, capture_intermediates=keep)
            return dict(taps=taps, inter=inter['intermediates'])
    else:
        jmodel = jax_segmentor(copy.deepcopy(tiny_cfg(name)))
        variables = jax_variables(jmodel, (1, size, size, 3))

        def run(v, x):
            # one forward: the taps are the backbone's captured output, and
            # the logits resized as ``encode_decode`` resizes them
            out, inter = jmodel.apply(v, x, capture_intermediates=keep)
            inter = inter['intermediates']
            logits = jax_resize(out['seg_logits'], size=x.shape[1:3],
                                mode='bilinear',
                                align_corners=jmodel.align_corners)
            return dict(taps=inter['backbone_mod']['__call__'][0],
                        inter=inter, feats=out['feats'],
                        head_logits=out['seg_logits'],
                        decoded=out['decoded_features'],
                        aux_logits=out['aux_logits'], logits=logits)
    out = run_jit(run, variables, img)
    out['inter'] = _captured(out['inter'], prefix, paths)
    return dict(variables=jax.tree.map(np.asarray, variables), img=img,
                out=jax.tree.map(np.asarray, out))


@pytest.fixture(scope='module')
def refs(tmp_path_factory):
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = shared_by_workers(
                tmp_path_factory, f'cnn_backbones_{name}',
                lambda: _jax_reference(name))
        return cache[name]
    return get


def _port(name, variables):
    """The def's segmentor, or MobileNetV2 in a holder module with the JAX
    tree under ``backbone_mod``, loaded with ``variables``."""
    if name != 'mobilenet_v2':
        return load_port(build_segmentor(tiny_cfg(name)), variables)
    holder = torch.nn.Module()
    holder.backbone = build_backbone(dict(MOBILENET_V2))
    return load_port(holder, {
        k: {'backbone_mod': v} for k, v in variables.items()})


def _t(tree):
    """A JAX output (an NHWC array, or a list of them) as the port's."""
    return [nchw(a) for a in tree] if isinstance(tree, (list, tuple)) \
        else nchw(tree)


def _close(got, want):
    got = got if isinstance(got, (list, tuple)) else [got]
    want = want if isinstance(want, (list, tuple)) else [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(nhwc(g), w, **TOL)


# ------------------------------ the modules ------------------------------
@pytest.mark.parametrize('name, module, inp', MODULES)
def test_module_matches_jax(name, module, inp, refs):
    """The module on the JAX program's own input to it (the output of the
    module before): its output within 1e-4 of the JAX module's. HRNet's
    module fuses three branches up and down; ConvNeXt's block runs its
    depthwise 7x7, LayerNorm, Dense layers and layer scale; the inverted
    residuals keep their identity; CGNet's block its gate."""
    r = refs(name)
    port = _port(name, r['variables']).backbone
    inter = r['out']['inter']
    with torch.no_grad():
        got = getattr(port, module)(_t(inter[inp]))
    _close(got, inter[module])


def test_mobilenet_v2_matches_jax(refs):
    """MobileNetV2 at widen factor 0.25: every tap within 1e-4."""
    r = refs('mobilenet_v2')
    with torch.no_grad():
        taps = _port('mobilenet_v2', r['variables']).backbone(nchw(r['img']))
    _close(taps, list(r['out']['taps']))


@pytest.mark.parametrize('name, part', [
    ('lraspp_m-v3-d8', 'decode_head'), ('fast_scnn', 'decode_head'),
    ('icnet_r50-d8', 'neck')])
def test_head_and_neck_match_jax(name, part, refs):
    """``LRASPPHead`` and ``DepthwiseSeparableFCNHead`` on the JAX
    program's taps (logits and features), ``ICNeck`` on them (its three
    outputs): within 1e-4."""
    r = refs(name)
    port = _port(name, r['variables'])
    taps = _t(r['out']['taps'])
    with torch.no_grad():
        got = getattr(port, part)(taps)
    want = [r['out']['head_logits'], r['out']['decoded']] \
        if part == 'decode_head' else list(r['out']['feats'])
    _close(list(got), want)


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
    _close(taps, list(want['taps']))
    _close(out['feats'], list(want['feats']))
    _close([out['seg_logits'], out['decoded_features'], logits],
           [want['head_logits'], want['decoded'], want['logits']])
    _close(out['aux_logits'], list(want['aux_logits']))
    assert states['decoded_features'].shape == out['decoded_features'].shape


# ------------------------------- the keys -------------------------------
def test_keys_of_the_cnn_family(refs):
    """The ``cnn`` family's map: a ConvModule, a ResNet block inside
    HRNet, CGNet's standalone norm, ConvNeXt's layer scale and Dense
    layers, a sub-backbone under flax's auto-name, ICNet's PPM, the neck,
    and LR-ASPP's own classifier; the optimizer's paths follow it."""
    cases = [
        ('backbone.enc0.conv1.bn.running_var', 1,
         'batch_stats/backbone_mod/enc0/conv1/norm/bn/var'),
        ('backbone.layer1_block0.downsample.0.weight', 4,
         'params/backbone_mod/layer1_block0/downsample/conv/conv/kernel'),
        ('backbone.stage3_module0.branch1_block0.bn2.weight', 1,
         'params/backbone_mod/stage3_module0/branch1_block0/conv2/norm/bn/'
         'scale'),
        ('backbone.stage0_block1.bn.bn.running_mean', 1,
         'batch_stats/backbone_mod/stage0_block1/bn/bn/mean'),
        ('backbone.stage2_block0.gamma', 1,
         'params/backbone_mod/stage2_block0/gamma'),
        ('backbone.stage2_block0.norm.weight', 1,
         'params/backbone_mod/stage2_block0/norm/scale'),
        ('backbone.stage2_block0.pwconv1.weight', 2,
         'params/backbone_mod/stage2_block0/pwconv1/kernel'),
        ('backbone.context.ResNet_0.layer2.0.downsample.1.bias', 1,
         'params/backbone_mod/context/ResNet_0/layer2_block0/downsample/'
         'conv/norm/bn/bias'),
        ('backbone.backbone.ResNetV1c_0.stem.0.weight', 4,
         'params/backbone_mod/backbone/ResNetV1c_0/stem_conv1/conv/kernel'),
        ('backbone.psp.3.1.conv.weight', 4,
         'params/backbone_mod/psp/pool3/conv/kernel'),
        ('neck.cff1_small.bn.weight', 1,
         'params/neck_mod/cff1_small/norm/bn/scale')]
    for key, ndim, path in cases:
        coll, *path = path.split('/')
        assert torch_key_to_flax(key, ndim, backbone='cnn', neck='cnn') == \
            (coll, path), key
    assert torch_key_to_flax('decode_head.conv_seg.weight', 4,
                             lraspp=True) == (
        'params', ['decode_head_mod', 'conv_seg', 'kernel'])
    assert torch_key_to_flax('decode_head.lateral.1.bias', 1) == (
        'params', ['decode_head_mod', 'lateral1', 'bias'])
    port = _port('lraspp_m-v3-d8', refs('lraspp_m-v3-d8')['variables'])
    paths = param_paths(port.named_parameters(), **key_families(port))
    assert paths['backbone.b3_se1.weight'] == 'backbone_mod/b3_se1/kernel'
    assert paths['decode_head.conv_seg.weight'] == \
        'decode_head_mod/conv_seg/kernel'
    assert paths['decode_head.fuse.0.conv.weight'] == \
        'decode_head_mod/fuse0/conv/kernel'


def _port_shape(shape, path, ndim):
    """A JAX leaf's shape in the port's layout (``core.convert``)."""
    if len(shape) == 4:
        return (shape[3], shape[2], shape[0], shape[1])
    if len(shape) == 2 and path[-1] == 'kernel':
        return (shape[1], shape[0]) + (1, 1) * (ndim == 4)
    return tuple(shape)


@pytest.mark.parametrize('name', DEFS)
def test_full_width_state_dict_matches_the_jax_tree(name):
    """The def as its config stands: the port built on the meta device,
    the JAX tree from ``jax.eval_shape`` of ``init`` at 32^2; each key of
    the port maps to a JAX leaf of its shape, and every leaf has a key.
    This holds the heads built at their fed width (ICNet's decode head
    256 wide, CGNet's classifier 128) at the configs' real widths."""
    cfg = Config.fromfile(osp.join(CONFIGS, f'{name}.py')).to_dict()['model']
    with torch.device('meta'):
        port = build_segmentor(copy.deepcopy(cfg))
    jmodel = jax_segmentor(copy.deepcopy(cfg))
    tree = jax.eval_shape(lambda: jmodel.init(
        {'params': jax.random.PRNGKey(0)}, jnp.zeros((1, 32, 32, 3))))
    leaves = {tuple(getattr(k, 'key', k) for k in path): leaf.shape
              for path, leaf in jax.tree_util.tree_leaves_with_path(
                  dict(tree))}
    sd = port.state_dict()
    uper, lraspp = uper_heads(sd), lraspp_heads(sd)
    seen, bad = set(), []
    for key, ref in sd.items():
        if key.endswith('num_batches_tracked'):
            continue
        mapped = torch_key_to_flax(key, ref.ndim, uper=head_prefix(key) in
                                   uper, lraspp=head_prefix(key) in lraspp,
                                   **key_families(port))
        path = None if mapped is None else (mapped[0], *mapped[1])
        if path not in leaves or _port_shape(leaves[path], path,
                                             ref.ndim) != tuple(ref.shape):
            bad.append((key, tuple(ref.shape), leaves.get(path)))
        seen.add(path)
    assert not bad
    assert set(leaves) == seen


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


@pytest.mark.parametrize('name', ['fcn_unet_s5-d16', 'fcn_hr18',
                                  'upernet_convnext', 'icnet_r50-d8'])
def test_supervised_sgd_step_matches_jax(name, refs):
    """One SGD step of ``SupervisedTrainer`` against the JAX trainer's
    from the same weights and batch: log vars and every parameter and BN
    statistic after the step."""
    size = SIZE.get(name, 64)
    variables = refs(name)['variables']
    rs = np.random.RandomState(6)
    img = _images(rs, 2, size)
    n_cls = tiny_cfg(name)['decode_head']['num_classes']
    gt = rs.randint(0, n_cls, (2, size, size)).astype(np.int32)
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
