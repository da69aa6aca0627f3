"""The port's MiT (SegFormer) and Twins (PCPVT, SVT) backbones and the
SegFormer head against the JAX package on the CPU.

The three ``configs/_base_/models`` defs at narrow widths: MiT with
``embed_dims`` 8 and heads (1, 2), 2 stages of 1 layer, on 40^2 inputs
(stage grids 10^2 and 5^2 against ``sr`` 8 and 4: neither a multiple, so
the spatial-reduction conv pads as flax's ``SAME`` does); PCPVT with
widths (16, 32), heads (1, 2), 2 blocks then 1 (the PEG after each
stage's first), on 46^2 inputs (grids 12^2 and 6^2: the first patch
embedding pads, and ``sr`` 8 and 4 pad again); SVT alone at the same widths on 40^2 (window 4 on
the 10^2 and 5^2 grids: the locally-grouped attention pads, then its
second block is global); heads at 8-16 channels and 5 classes. Weights
come from ``torch_parity.jax_variables`` through
``jax_variables_to_state_dict``, which must fill every key. One JAX
program a def computes the backbone's taps (with every module's output
captured, ``capture_intermediates``), the neck's outputs, the heads'
logits and features and the segmentor's logits, shared by the tests
(and across xdist's workers) through ``torch_parity.shared_by_workers``;
each module is held on the JAX program's own inputs to it (a block's
norm output, the first block's output for the PEG, the taps for the
head), each segmentor on the image. The attention runs its plain version
here (keys shorter than the queries); ``chip_smoke.py`` holds the card's
kernels to it.

Tolerances: ``test_torch_a13_heads.py``'s. Forward atol 1e-4, rtol 1e-4
(fp32 in another order); the step's log vars rtol 2e-4, atol 2e-5,
post-step parameters rtol 1e-3, atol 3e-5, BN statistics rtol 2e-3,
atol 2e-4 after the n/(n-1) gap of ROADMAP C2.
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
                          nchw, nhwc, run_jit, shared_by_workers,
                          two_pass_batch_variance)

from pfst_tpu.apis.train import SupervisedTrainer as JaxTrainer  # noqa: E402
from pfst_tpu.core import optimizers as jax_opt  # noqa: E402
from pfst_tpu.models import build_backbone as jax_backbone  # noqa: E402
from pfst_tpu.models import build_segmentor as jax_segmentor  # noqa: E402
from pfst_tpu.models.uda.uda_decorator import UDATrainState  # noqa: E402
from pfst_tpu_torch.apis import build_algorithm  # noqa: E402
from pfst_tpu_torch.core import (build_optimizer,  # noqa: E402
                                 jax_variables_to_state_dict, param_paths)
from pfst_tpu_torch.core.convert import (key_families,  # noqa: E402
                                         torch_key_to_flax)
from pfst_tpu_torch.models import build_backbone, build_segmentor  # noqa: E402
from pfst_tpu_torch.models.backbones.mit import pad_same  # noqa: E402
from pfst_tpu_torch.utils import Config  # noqa: E402

sys.path.insert(0, osp.join(osp.dirname(__file__), '..', 'tools'))
from convert_torch_checkpoint import \
    convert_transformer_state_dict  # noqa: E402

CONFIGS = osp.join(osp.dirname(__file__), '..', 'configs', '_base_',
                   'models')
TOL = dict(atol=1e-4, rtol=1e-4)
SGD = dict(type='SGD', lr=1e-2)
DEFS = ['segformer_mit-b0', 'twins_pcpvt-s_upernet', 'twins_pcpvt-s_fpn']
SIZE = {'segformer_mit-b0': 40, 'twins_pcpvt-s_upernet': 46,
        'twins_pcpvt-s_fpn': 46, 'svt': 40}
TWINS = dict(embed_dims=(16, 32), num_heads=(1, 2), depths=(2, 1),
             sr_ratios=(8, 4), patch_sizes=(4, 2), mlp_ratios=(2, 2),
             out_indices=(0, 1), drop_path_rate=0.0)
SVT = dict(type='SVT', windows=(4, 4), **TWINS)


def _head(cfg, **kw):
    cfg.update(kw, dropout_ratio=0.0, num_classes=5)
    return cfg


def tiny_cfg(name):
    """A def of ``DEFS`` at narrow widths (module docstring)."""
    cfg = Config.fromfile(osp.join(CONFIGS, f'{name}.py')).to_dict()['model']
    head = cfg['decode_head']
    if name == 'segformer_mit-b0':
        cfg['backbone'].update(embed_dims=8, num_stages=2, num_layers=(1, 1),
                               num_heads=(1, 2), patch_sizes=(7, 3),
                               strides=(4, 2), sr_ratios=(8, 4),
                               out_indices=(0, 1), drop_path_rate=0.0)
        _head(head, in_channels=(8, 16), in_index=(0, 1), channels=16)
        return cfg
    cfg['backbone'].update(TWINS)
    if name == 'twins_pcpvt-s_fpn':
        cfg['neck'].update(in_channels=(16, 32), out_channels=8, num_outs=2)
        _head(head, in_channels=(8, 8), in_index=(0, 1),
              feature_strides=(4, 8), channels=8)
    else:
        _head(head, in_channels=(16, 32), in_index=(0, 1), channels=8)
        _head(cfg['auxiliary_head'], in_channels=32, in_index=1, channels=8)
    return cfg


def _images(rs, b, size):
    """Normal noise, each image shifted by its own offset (train-mode BN
    of a pooled branch normalizes one value per image)."""
    shift = np.linspace(-2.0, 2.0, b).reshape(b, 1, 1, 1)
    return (rs.randn(b, size, size, 3) + shift).astype(np.float32)


def _outputs(tree):
    """Every module's captured ``__call__`` output, by its ``/``-joined
    path (numpy)."""
    return {'/'.join(str(getattr(k, 'key', k)) for k in path[:-2]): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)
            if getattr(path[-2], 'key', None) == '__call__'}


def _jax_reference(name):
    """The JAX model's variables, and on two seeded images its backbone
    taps and every backbone module's output, its neck outputs, head logits
    and features, auxiliary logits and the segmentor's logits (numpy)."""
    size = SIZE[name]
    img = _images(np.random.RandomState(4), 2, size)
    if name == 'svt':
        jmodel = jax_backbone(dict(SVT))
        variables = jax_variables(jmodel, (1, size, size, 3))

        def run(v, x):
            taps, inter = jmodel.apply(v, x, capture_intermediates=True)
            return dict(taps=taps, inter=inter['intermediates'])
    else:
        jmodel = jax_segmentor(copy.deepcopy(tiny_cfg(name)))
        variables = jax_variables(jmodel, (1, size, size, 3))

        def run(v, x):
            taps, inter = jmodel.apply(
                v, x, method=lambda m, t: m.backbone_mod(t),
                capture_intermediates=True)
            out = jmodel.apply(v, x)
            logits, _ = jmodel.apply(v, x, method=jmodel.encode_decode)
            return dict(taps=taps, inter=inter['intermediates'],
                        feats=out['feats'], head_logits=out['seg_logits'],
                        decoded=out['decoded_features'],
                        aux_logits=out['aux_logits'], logits=logits)

    out = jax.tree.map(np.asarray, run_jit(run, variables, img))
    out['inter'] = _outputs(out['inter'])
    return dict(variables=jax.tree.map(np.asarray, variables), img=img,
                out=out)


@pytest.fixture(scope='module')
def refs(tmp_path_factory):
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = shared_by_workers(
                tmp_path_factory, f'mit_twins_{name}',
                lambda: _jax_reference(name))
        return cache[name]
    return get


def _port(name, variables):
    """The def's segmentor, or SVT in a holder module with the JAX tree
    under ``backbone_mod``, loaded with ``variables``."""
    if name != 'svt':
        return load_port(build_segmentor(tiny_cfg(name)), variables)
    holder = torch.nn.Module()
    holder.backbone = build_backbone(dict(SVT))
    return load_port(holder, {'params': {
        'backbone_mod': variables['params']}})


def _close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(nhwc(g), w, **TOL)


def _tokens(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------ the modules ------------------------------
@pytest.mark.parametrize('name, module, inp, hw', [
    # MiT's spatial-reduction attention, sr 8 on a 10^2 grid (padded)
    ('segformer_mit-b0', 'stage0_block0/attn', 'stage0_block0/norm1',
     (10, 10)),
    ('segformer_mit-b0', 'stage1_block0/ffn', 'stage1_block0/norm2', (5, 5)),
    # PCPVT's global attention on a 12^2 grid, its PEG on a 6^2 one
    ('twins_pcpvt-s_fpn', 's0_b1/attn', 's0_b1/norm1', (12, 12)),
    ('twins_pcpvt-s_fpn', 'peg1', 's1_b0', (6, 6)),
    # SVT's locally-grouped attention, window 4 on 10^2 and 5^2 (padded)
    ('svt', 's0_b0/attn', 's0_b0/norm1', (10, 10)),
    ('svt', 's1_b0/attn', 's1_b0/norm1', (5, 5))])
def test_module_matches_jax(name, module, inp, hw, refs):
    """The module on the JAX program's own input to it (a block's norm
    output, the first block's output for the PEG): its output within
    1e-4 of the JAX module's."""
    r = refs(name)
    port = _port(name, r['variables']).backbone
    prefix = '' if name == 'svt' else 'backbone_mod/'
    inter = r['out']['inter']
    if module.startswith('stage'):
        i, j = int(module[5]), int(module[12])
        sub = port.layers[i][1][j]
    else:
        sub = getattr(port, module.split('/')[0])
    if '/' in module:
        sub = getattr(sub, module.split('/')[1])
    with torch.no_grad():
        got = sub(_tokens(inter[prefix + inp]), hw)
    np.testing.assert_allclose(got.numpy(), inter[prefix + module], **TOL)


def test_segformer_head_matches_jax(refs):
    """``SegformerHead`` on the JAX program's taps: logits and the fused
    features within 1e-4."""
    r = refs('segformer_mit-b0')
    head = _port('segformer_mit-b0', r['variables']).decode_head
    with torch.no_grad():
        logits, fused = head([nchw(t) for t in r['out']['taps']])
    _close([logits, fused], [r['out']['head_logits'], r['out']['decoded']])


def test_svt_backbone_matches_jax(refs):
    """SVT: every tap within 1e-4 (locally-grouped then global attention
    in each stage's blocks, the windows padded)."""
    r = refs('svt')
    with torch.no_grad():
        taps = _port('svt', r['variables']).backbone(nchw(r['img']))
    _close(taps, r['out']['taps'])


@pytest.mark.parametrize('name', DEFS)
def test_segmentor_matches_jax(name, refs):
    """The def's segmentor from its config: every key filled from the JAX
    tree, and its taps, neck outputs, head logits and features, the
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


# ------------------------------- the keys -------------------------------
def test_every_key_has_a_source_and_mmseg_mit_keys_convert(refs):
    """``jax_variables_to_state_dict`` fills every key of the three defs
    (the auxiliary head too) and of SVT; the port's MiT keys are mmseg's,
    and its state dict, through the JAX tool's
    ``convert_transformer_state_dict(sd, 'mit')``, gives back the JAX
    backbone's every leaf; the SegFormer head's ``convs`` map to the JAX
    file's ``proj``, and the in-projection's path (``q|k|v``) labels it
    for the optimizer."""
    for name in DEFS:
        port = build_segmentor(tiny_cfg(name))
        sd = jax_variables_to_state_dict(refs(name)['variables'],
                                         port.state_dict(),
                                         **key_families(port))
        assert sd.keys() == port.state_dict().keys()
    assert _port('svt', refs('svt')['variables']).backbone.key_family == \
        'twins'
    r = refs('segformer_mit-b0')
    port = _port('segformer_mit-b0', r['variables'])
    sd = port.state_dict()
    for key in ('backbone.layers.0.0.projection.weight',
                'backbone.layers.0.0.norm.weight',
                'backbone.layers.1.1.0.attn.attn.in_proj_weight',
                'backbone.layers.1.1.0.attn.attn.out_proj.bias',
                'backbone.layers.0.1.0.attn.sr.weight',
                'backbone.layers.0.1.0.attn.norm.bias',
                'backbone.layers.0.1.0.ffn.layers.4.weight',
                'backbone.layers.1.2.weight',
                'decode_head.convs.1.conv.weight',
                'decode_head.fusion_conv.bn.running_var'):
        assert key in sd, key
    assert sd['backbone.layers.0.1.0.ffn.layers.0.weight'].shape == \
        (32, 8, 1, 1)
    params, _, skipped = convert_transformer_state_dict(
        {k: v for k, v in sd.items() if k.startswith('backbone.')}, 'mit')
    assert not skipped
    want = dict(jax.tree_util.tree_leaves_with_path(
        r['variables']['params']['backbone_mod']))
    got = jax.tree_util.tree_leaves_with_path(params['backbone_mod'])
    assert len(got) == len(want)
    for path, leaf in got:
        np.testing.assert_array_equal(leaf, want[path], err_msg=str(path))
    assert torch_key_to_flax('decode_head.convs.1.bn.weight', 1,
                             segformer=True) == (
        'params', ['decode_head_mod', 'proj1', 'norm', 'bn', 'scale'])
    paths = param_paths(port.named_parameters(), **key_families(port))
    assert paths['backbone.layers.0.1.0.attn.attn.in_proj_weight'] == \
        'backbone_mod/stage0_block0/attn/q|k|v/kernel'
    assert paths['decode_head.fusion_conv.conv.weight'] == \
        'decode_head_mod/fusion/conv/kernel'


def test_pad_same_splits_as_xla():
    """flax's ``SAME`` for a kernel equal to its stride: up to a multiple,
    the smaller half before (11 -> 16 at stride 8: 2 before, 3 after)."""
    x = torch.ones(1, 1, 11, 8)
    y = pad_same(x, 8)
    assert y.shape == (1, 1, 16, 8)
    assert y[0, 0, :, 0].tolist() == [0.0] * 2 + [1.0] * 11 + [0.0] * 3
    z = x[:, :, :8]
    assert pad_same(z, 8) is z


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


@pytest.mark.parametrize('name', ['segformer_mit-b0', 'twins_pcpvt-s_fpn'])
def test_supervised_sgd_step_matches_jax(name):
    """One SGD step of ``SupervisedTrainer`` against the JAX trainer's
    from the same weights and batch: log vars and every parameter and BN
    statistic after the step."""
    size = SIZE[name]
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
