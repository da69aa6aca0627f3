"""The port's last three backbones (ResNeXt, ResNeSt, ``TIMMBackbone``)
against the JAX package on the CPU.

The configs of the JAX package's own tests (``tests/test_models.py:39``,
``tests/test_models_heads2.py:124``): ResNeXt-50 with base 8, 4 groups of
base width 4 on 32^2; ResNeSt-50 with base 8 and radix 2, its base width
16 (at the JAX test's 4 the bottleneck of stage 1 is
``int(8 * 4 / 64) = 0`` channels wide, which flax takes and torch's conv
refuses); ``TIMMBackbone('resnet50')`` at full width on 32^2. Weights come
from ``torch_parity.jax_variables`` through ``jax_variables_to_state_dict``
under a holder module (``backbone``, the JAX tree's ``backbone_mod``),
which must fill every key; the JAX tool ``convert_state_dict`` carries the
port's ResNeXt back to the JAX tree. One SGD step of ResNeSt (the
split-attention conv, its Dense layers and BatchNorm1d, at output stride
8) under an FCN head against the JAX trainer's; ResNeXt's grouped conv
is held in its forward here and in ``tests/test_torch_quant.py``.
Tolerances: ``test_torch_cnn_backbones.py``'s.
"""
import os.path as osp
import sys

import numpy as np
import pytest
import torch

# torch's OpenMP pool must not run beside XLA-CPU in one process
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))),
                            'tools'))

from convert_torch_checkpoint import convert_state_dict  # noqa: E402
from torch_parity import (FAST_COMPILE, jax_variables, load_port,  # noqa: E402
                          nchw, nhwc, run_jit, two_pass_batch_variance)

from pfst_tpu.apis.train import SupervisedTrainer as JaxTrainer  # noqa: E402
from pfst_tpu.core import optimizers as jax_opt  # noqa: E402
from pfst_tpu.models import build_backbone as jax_backbone  # noqa: E402
from pfst_tpu.models import build_segmentor as jax_segmentor  # noqa: E402
from pfst_tpu.models.uda.uda_decorator import UDATrainState  # noqa: E402
from pfst_tpu_torch.apis import build_algorithm  # noqa: E402
from pfst_tpu_torch.core import build_optimizer  # noqa: E402
from pfst_tpu_torch.core.convert import (jax_variables_to_state_dict,  # noqa: E402
                                         key_families)
from pfst_tpu_torch.models import build_backbone  # noqa: E402

NORM = dict(type='BN', requires_grad=True)
BACKBONES = {
    'resnext': (dict(type='ResNeXt', depth=50, base_channels=8,
                     stem_channels=8, groups=4, base_width=4,
                     norm_cfg=NORM), 32),
    'resnest': (dict(type='ResNeSt', depth=50, base_channels=8,
                     stem_channels=8, radix=2, base_width=16,
                     norm_cfg=NORM), 32),
    'timm_resnet50': (dict(type='TIMMBackbone', model_name='resnet50',
                           norm_cfg=NORM), 32),
}
SGD = dict(type='SGD', lr=0.05, momentum=0.9, weight_decay=5e-4)
# the step's batch: ResNeSt's attention BN (``fc1_bn``) normalizes one
# pooled value an image, so at batch 2 its fp32 gradients are
# ill-conditioned (the port's own fp32 step lies 9e-4 from float64 in the
# stem's updated weights, as far as from JAX); at batch 8, 2e-8
STEP_BATCH = {'resnest': 8}


class _Holder(torch.nn.Module):
    def __init__(self, backbone):
        super().__init__()
        self.backbone = backbone


def _images(rs, n, size):
    return rs.uniform(0, 255, (n, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize('name', sorted(BACKBONES))
def test_backbone_outputs_match_jax(name):
    """The backbone's feature maps in eval mode, from the same weights."""
    cfg, size = BACKBONES[name]
    jmodel = jax_backbone(dict(cfg))
    variables = jax_variables(jmodel, (1, size, size, 3), seed=3)
    x = np.random.RandomState(4).randn(2, size, size, 3).astype(np.float32)
    ref = run_jit(lambda v, x: jmodel.apply(v, x), variables, jnp.asarray(x))
    holder = _Holder(build_backbone(dict(cfg)))
    load_port(holder, {'params': {'backbone_mod': variables['params']},
                       'batch_stats': {'backbone_mod':
                                       variables['batch_stats']}})
    with torch.no_grad():
        got = holder.backbone(nchw(x))
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(nhwc(g), np.asarray(r), rtol=1e-4,
                                   atol=1e-4)


def test_resnext_carries_to_jax_through_the_jax_tool():
    """``tools/convert_torch_checkpoint.py::convert_state_dict`` takes the
    port's ResNeXt state dict to the JAX tree it came from (mmseg's
    ResNet names, grouped kernels included)."""
    cfg, size = BACKBONES['resnext']
    jmodel = jax_backbone(dict(cfg))
    variables = jax_variables(jmodel, (1, size, size, 3), seed=3)
    holder = _Holder(build_backbone(dict(cfg)))
    load_port(holder, {'params': {'backbone_mod': variables['params']},
                       'batch_stats': {'backbone_mod':
                                       variables['batch_stats']}})
    params, stats, skipped = convert_state_dict(holder.state_dict())
    assert all(k.endswith('num_batches_tracked') for k in skipped)
    flat = jax.tree_util.tree_leaves_with_path(
        {'params': variables['params'], 'batch_stats':
         variables['batch_stats']})
    got = {'params': params['backbone_mod'],
           'batch_stats': stats['backbone_mod']}
    for path, leaf in flat:
        node = got
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(np.asarray(node), np.asarray(leaf))


def test_timm_backbone_raises_on_an_unknown_name():
    with pytest.raises(KeyError, match='no registered equivalent'):
        build_backbone(dict(type='TIMMBackbone', model_name='efficientnet_b0'))


def _seg_cfg(backbone):
    """The backbone at output stride 8 under an FCN head."""
    return dict(
        type='EncoderDecoder',
        backbone=dict(backbone, strides=(1, 2, 1, 1), dilations=(1, 1, 2, 4),
                      contract_dilation=True),
        decode_head=dict(type='FCNHead', in_channels=256, in_index=3,
                         channels=8, num_convs=1, concat_input=False,
                         dropout_ratio=0.0, num_classes=5, norm_cfg=NORM,
                         align_corners=False,
                         loss_decode=dict(type='CrossEntropyLoss',
                                          use_sigmoid=False,
                                          loss_weight=1.0)),
        train_cfg=dict(), test_cfg=dict(mode='whole'))


def _residual_scale(variables, scale=0.25):
    """Each residual block's last BN scale times ``scale``, as
    ``chip_smoke.py``'s step checks take them: at the draws' scales the
    fp32 gradients of the early layers are ill-conditioned (within 10 %
    of float64's at 64^2)."""
    for name, blk in variables['params']['backbone_mod'].items():
        if name.startswith('layer'):
            bn = blk['conv3']['norm']['bn']
            bn['scale'] = bn['scale'] * np.float32(scale)
    return variables


@pytest.mark.parametrize('name', ['resnest'])
def test_supervised_sgd_step_matches_jax(name):
    """One SGD step of ``SupervisedTrainer`` against the JAX trainer's from
    the same weights and batch: log vars and every parameter and BN
    statistic after the step (the running variance after torch's n/(n-1),
    ROADMAP C2)."""
    cfg, size = BACKBONES[name]
    seg = _seg_cfg(cfg)
    jmodel = jax_segmentor(seg)
    variables = _residual_scale(
        jax_variables(jmodel, (1, size, size, 3), seed=5))
    rs = np.random.RandomState(6)
    n = STEP_BATCH[name]
    img = _images(rs, n, size)
    gt = rs.randint(0, 5, (n, size, size)).astype(np.int32)
    gt[:, :2] = 255
    mean, std = [120.0, 110.0, 100.0], [60.0, 55.0, 58.0]
    tx = jax_opt.build_optimizer(SGD)
    jstate = UDATrainState(
        params=variables['params'], batch_stats=variables['batch_stats'],
        ema_params={}, ema_batch_stats={},
        opt_state=tx.init(variables['params']), step=jnp.zeros((), jnp.int32))
    step_fn = JaxTrainer(jmodel).make_train_step(tx, mean, std, jit=False)
    batch = {'img': img, 'gt_semantic_seg': gt}
    with two_pass_batch_variance():
        compiled = jax.jit(step_fn).lower(
            jstate, batch, jax.random.PRNGKey(0)).compile(FAST_COMPILE)
    new_state, ref_vars, _ = compiled(jstate, batch, jax.random.PRNGKey(0))

    algo = build_algorithm({'model': seg}, device='cpu')
    state = algo.init_state(torch.Generator().manual_seed(0),
                            build_optimizer(SGD))
    load_port(state.student, variables).train()
    counts = {}
    hooks = [m.register_forward_hook(
        lambda mod, inp, out, n=n: counts.__setitem__(
            n, inp[0].numel() // inp[0].shape[1]))
        for n, m in state.student.named_modules()
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
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
