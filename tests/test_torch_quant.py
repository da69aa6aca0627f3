"""The port's quantization (``pfst_tpu_torch/ops/quant.py``), BN folding
(``core/fold_bn.py``) and their CLIs against the JAX package on the CPU.

* One conv of each geometry (3x3 dilated, strided, 1x1, grouped,
  depthwise, 3 input channels, with and without a bias) and one Dense on
  a 3-D input: the port's int8 operands and integer sums equal the JAX
  interceptor's (read at its ``lax`` calls) on the same input, and the
  outputs of ``int8_inference`` and ``qat_training`` agree within 1e-6
  relative.
* ``calibrate_act_scales`` on the tiny DeepLabV3+ (``conftest.
  tiny_model_cfg``, the golden traces' widths), MiT and ResNeXt
  (``BottleneckX`` blocks (2, 2, 2, 2)) segmentors: the same keys as the
  JAX table, ``conv_seg`` absent, values within rtol 1e-5, at percentile
  100 and 99.9. The JAX tables come from one jitted program a model with
  the JAX file's statistics (``_jax_tables``); the JAX function itself
  writes the JAX tool's table in the last test.
* The tiny segmentor under ``int8_inference`` with JAX's calibrated
  scales on both sides: the port's logits within a tenth of JAX's own
  int8-against-fp32 gap of JAX's int8 logits, argmax agreement >= 99 %.
* One QAT step of the qat leaf config at tiny width (SGD, dropout off)
  against JAX's step traced under ``qat_training``.
* ``qat_context_from_cfg`` as ``tests/test_quant.py:380`` holds JAX's.
* ``fold_batch_norms``: the port's folded state dict is JAX's folded tree,
  and the eval output does not move.
* ``single_gpu_test(quant_int8=True)``, ``tools/calibrate_int8_torch.py``
  and ``tools/test_torch.py --quant-int8 --act-scales`` on the tiny qat
  config and synthetic tiles: mIoU within 2 points of fp32
  (``tests/test_quant.py:93``); the JAX tool's table (from the port's
  weights, carried by ``convert_state_dict``) has the port tool's keys
  and values and drives the port's CLI.
"""
import contextlib
import json
import os.path as osp
import sys
import types

import numpy as np
import pytest
import torch

# torch's OpenMP pool must not run beside XLA-CPU in one process
torch.set_num_threads(1)

import flax.linen as nn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, osp.join(REPO, 'tools'))

import calibrate_int8  # noqa: E402
import calibrate_int8_torch  # noqa: E402
import make_synthetic_data_torch  # noqa: E402
import test_torch  # noqa: E402
from conftest import tiny_model_cfg  # noqa: E402
from convert_torch_checkpoint import convert_state_dict  # noqa: E402
from torch_parity import (FAST_COMPILE, jax_variables, load_port,  # noqa: E402
                          nchw, nhwc, run_jit, two_pass_batch_variance)

from pfst_tpu.apis.train import SupervisedTrainer as JaxTrainer  # noqa: E402
from pfst_tpu.core import optimizers as jax_opt  # noqa: E402
from pfst_tpu.core.checkpoint import save_checkpoint as save_orbax  # noqa: E402
from pfst_tpu.core.fold_bn import fold_batch_norms as jax_fold  # noqa: E402
from pfst_tpu.models import build_segmentor as jax_segmentor  # noqa: E402
from pfst_tpu.models.uda.uda_decorator import UDATrainState  # noqa: E402
from pfst_tpu.ops import quant as jq  # noqa: E402
from pfst_tpu_torch.apis import build_algorithm, init_segmentor  # noqa: E402
from pfst_tpu_torch.apis import single_gpu_test  # noqa: E402
from pfst_tpu_torch.core import build_optimizer  # noqa: E402
from pfst_tpu_torch.core.convert import (jax_variables_to_state_dict,  # noqa: E402
                                         key_families)
from pfst_tpu_torch.core.fold_bn import fold_batch_norms  # noqa: E402
from pfst_tpu_torch.datasets import build_dataloader, build_dataset  # noqa: E402
from pfst_tpu_torch.models import build_segmentor  # noqa: E402
from pfst_tpu_torch.ops import quant as pq  # noqa: E402
from pfst_tpu_torch.utils import Config  # noqa: E402

QAT = osp.join(REPO, 'configs', 'pfst',
               'qat_source_only_pots_irrg_deeplabv3plus_r50-d8.py')
NORM = dict(type='BN', requires_grad=True)
SGD = dict(type='SGD', lr=0.05, momentum=0.9, weight_decay=5e-4)


# ------------------------------- one layer -------------------------------
class _LaxRecorder(types.SimpleNamespace):
    """``jax.lax`` for the JAX quant module, recording the operands and
    result of each integer product it emits."""

    def __init__(self):
        super().__init__(calls=[])

    def __getattr__(self, name):
        return getattr(jax.lax, name)

    def conv_general_dilated(self, x, w, *args, **kwargs):
        y = jax.lax.conv_general_dilated(x, w, *args, **kwargs)
        if kwargs.get('preferred_element_type') == jnp.int32:
            self.calls.append((x, w, y))
        return y

    def dot_general(self, x, w, dims, *args, **kwargs):
        y = jax.lax.dot_general(x, w, dims, *args, **kwargs)
        if kwargs.get('preferred_element_type') == jnp.int32:
            self.calls.append((x, w, y))
        return y


class _Holder(torch.nn.Module):
    """One layer under the name a root's key map gives a JAX path
    (``conv0``: ``discriminator_key_to_flax``), registered as a root."""

    def __init__(self, layer):
        super().__init__()
        self.conv0 = layer
        pq.track_root(self)


# (in channels, out channels, kernel, stride, padding, dilation, groups,
# bias, input H x W)
CONVS = {
    '3x3_dilated': (8, 16, 3, 1, 2, 2, 1, True, 13),
    '3x3_strided': (8, 12, 3, 2, 1, 1, 1, False, 15),
    '1x1': (16, 24, 1, 1, 0, 1, 1, True, 9),
    'grouped': (16, 32, 3, 1, 1, 1, 4, False, 11),
    'depthwise': (16, 16, 3, 1, 12, 12, 16, True, 20),
    'cin3': (3, 8, 3, 2, 1, 1, 1, False, 17),
}


def _layer_case(name):
    rs = np.random.RandomState(sum(map(ord, name)))
    if name == 'dense':
        x = rs.randn(4, 7, 24).astype(np.float32)
        kernel = (rs.randn(24, 40) * np.sqrt(2 / 24)).astype(np.float32)
        bias = (0.1 * rs.randn(40)).astype(np.float32)
        jm = nn.Dense(40)
        port = torch.nn.Linear(24, 40)
        port.weight.data = torch.from_numpy(kernel.T.copy())
        port.bias.data = torch.from_numpy(bias)
        return jm, {'kernel': kernel, 'bias': bias}, x, _Holder(port)
    cin, cout, k, s, p, d, g, use_bias, hw = CONVS[name]
    x = rs.randn(2, hw, hw, cin).astype(np.float32)
    kernel = (rs.randn(k, k, cin // g, cout)
              * np.sqrt(2 / (k * k * cin // g))).astype(np.float32)
    jm = nn.Conv(cout, (k, k), strides=(s, s), padding=((p, p), (p, p)),
                 kernel_dilation=(d, d), feature_group_count=g,
                 use_bias=use_bias)
    port = torch.nn.Conv2d(cin, cout, k, s, p, d, groups=g, bias=use_bias)
    port.weight.data = torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy())
    params = {'kernel': kernel}
    if use_bias:
        params['bias'] = (0.1 * rs.randn(cout)).astype(np.float32)
        port.bias.data = torch.from_numpy(params['bias'])
    return jm, params, x, _Holder(port)


def _to_port(a):
    a = np.asarray(a)
    return a.transpose(0, 3, 1, 2) if a.ndim == 4 else a


def _kernel_to_port(a):
    a = np.asarray(a)
    return a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T


@pytest.mark.parametrize('name', sorted(CONVS) + ['dense'])
def test_layer_int8_operands_sums_and_outputs_match_jax(name, monkeypatch):
    jm, params, x, holder = _layer_case(name)
    rec = _LaxRecorder()
    monkeypatch.setattr(jq, 'lax', rec)

    def jax_side(params, x):
        with jq.int8_inference(skip=()):
            int8 = jm.apply({'params': params}, x)
        with jq.qat_training(skip=()):
            qat = jm.apply({'params': params}, x)
        (operands,) = rec.calls
        return int8, qat, operands

    jax_int8, jax_qat, (jqx, jqw, jy) = jax.tree.map(
        np.asarray, run_jit(jax_side, params, jnp.asarray(x)))
    seen = []
    xt = nchw(x) if x.ndim == 4 else torch.from_numpy(x)
    with torch.no_grad():
        with pq.int8_inference(skip=(),
                               observer=lambda *a: seen.append(a)):
            port_int8 = holder.conv0(xt)
        with pq.qat_training(skip=()):
            port_qat = holder.conv0(xt)
    (path, _, qx, qw, _, y), = seen
    assert path == 'conv0'
    assert qx.dtype == qw.dtype == torch.int8
    np.testing.assert_array_equal(qx.numpy(), _to_port(jqx))
    np.testing.assert_array_equal(qw.numpy(), _kernel_to_port(jqw))
    np.testing.assert_array_equal(y.numpy(), _to_port(jy).astype(np.float64))
    for got, want in ((port_int8, jax_int8), (port_qat, jax_qat)):
        got = _to_port(nhwc(got)) if got.dim() == 4 else got.numpy()
        want = _to_port(want)
        gap = np.abs(got - want).max() / np.abs(want).max()
        assert gap <= 1e-6, gap


# ---------------------------- calibration ----------------------------
def _seg_cfg(backbone, in_channels, in_index=3):
    return dict(
        type='EncoderDecoder', backbone=backbone,
        decode_head=dict(type='FCNHead', in_channels=in_channels,
                         in_index=in_index, channels=8, num_convs=1,
                         concat_input=False, dropout_ratio=0.0,
                         num_classes=6, norm_cfg=NORM, align_corners=False,
                         loss_decode=dict(type='CrossEntropyLoss',
                                          loss_weight=1.0)),
        train_cfg=dict(), test_cfg=dict(mode='whole'))


MODELS = {
    'deeplabv3plus': (tiny_model_cfg(), 64),
    'mit': (_seg_cfg(dict(type='MixVisionTransformer', embed_dims=8,
                          num_layers=(1, 1, 1, 1), num_heads=(1, 1, 1, 1)),
                     8), 64),
    'resnext': (_seg_cfg(dict(type='ResNeXt', depth=18, base_channels=8,
                              stem_channels=8, groups=4, base_width=4,
                              strides=(1, 2, 1, 1), dilations=(1, 1, 2, 4),
                              contract_dilation=True, norm_cfg=NORM), 256),
                64),
}


@pytest.fixture(scope='module')
def models():
    """Each model's JAX module and variables, the port's model and one
    input image (NHWC)."""
    out = {}
    for i, (name, (cfg, size)) in enumerate(sorted(MODELS.items())):
        jm = jax_segmentor(dict(cfg))
        v = jax_variables(jm, (1, size, size, 3), seed=i)
        pm = load_port(build_segmentor(dict(cfg)), v)
        x = np.random.RandomState(10 + i).randn(1, size, size, 3).astype(
            np.float32)
        out[name] = (jm, v, pm, x)
    return out


PERCENTILES = (100.0, 99.9)


def _jax_tables(jm, v, x, skip=jq.DEFAULT_SKIP):
    """``jq.calibrate_act_scales``'s tables of one image at
    ``PERCENTILES`` in one jitted program: its layer set
    (``_should_skip``, ``_conv_path``), its statistic (``max|x|``, or
    ``jnp.percentile`` of ``|x|`` in fp32) and its running max. The JAX
    function itself (eager) is held to the port's tool in
    ``test_int8_eval_and_clis``."""

    def run(v, x):
        stats = {p: {} for p in PERCENTILES}

        def rec(next_fun, args, kwargs, context):
            mod = context.module
            if (isinstance(mod, (nn.Conv, nn.Dense))
                    and context.method_name == '__call__'
                    and not jq._should_skip(jq._conv_path(mod), skip)):
                ax = jnp.abs(args[0])
                path = jq._conv_path(mod)
                for p, table in stats.items():
                    s = jnp.max(ax) if p >= 100.0 else jnp.percentile(
                        ax.astype(jnp.float32), p)
                    table[path] = jnp.maximum(table[path], s) \
                        if path in table else s
            return next_fun(*args, **kwargs)

        with nn.intercept_methods(rec):
            jm.apply(v, x, method=jm.inference)
        return stats

    out = run_jit(run, v, jnp.asarray(x))
    return {p: {k: float(s) for k, s in t.items()} for p, t in out.items()}


@pytest.fixture(scope='module')
def jax_tables(models):
    return {(name, p): table
            for name, (jm, v, _, x) in models.items()
            for p, table in _jax_tables(jm, v, x).items()}


@pytest.mark.parametrize('percentile', PERCENTILES)
@pytest.mark.parametrize('name', sorted(MODELS))
def test_calibration_table_matches_jax(name, percentile, models, jax_tables):
    _, _, pm, x = models[name]
    with torch.inference_mode():
        got = pq.calibrate_act_scales(pm.inference, [nchw(x)],
                                      percentile=percentile)
    want = jax_tables[(name, percentile)]
    assert set(got) == set(want)
    assert not [k for k in got if 'conv_seg' in k]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_percentile_beyond_torch_quantile_sizes():
    """``percentile_abs`` is ``np.percentile`` of ``|x|`` (linear), by a
    sort that takes more than torch.quantile's 2^24 elements."""
    x = torch.from_numpy(np.random.RandomState(3).randn(2**24 + 5).astype(
        np.float32))
    np.testing.assert_allclose(pq.percentile_abs(x, 99.9),
                               np.percentile(np.abs(x.numpy()), 99.9),
                               rtol=1e-6)


# ------------------------------- int8 program -----------------------------
def test_segmentor_int8_matches_jax_int8(models, jax_tables):
    """Port against JAX, both int8 with JAX's calibrated scales: the
    logits' largest gap a tenth of JAX's own int8-against-fp32 gap or
    less, argmax agreement >= 99 % (``CHANGES.md`` records the numbers)."""
    jm, v, pm, x = models['deeplabv3plus']
    scales = jax_tables[('deeplabv3plus', 100.0)]

    def logits(v, x, int8):
        with (jq.int8_inference(act_scales=scales) if int8
              else contextlib.nullcontext()):
            return jm.apply(v, x, method=jm.inference_logits)[0]

    jfp = np.asarray(run_jit(lambda v, x: logits(v, x, False), v,
                             jnp.asarray(x)))
    jint8 = np.asarray(run_jit(lambda v, x: logits(v, x, True), v,
                               jnp.asarray(x)))
    with torch.inference_mode(), pq.int8_inference(act_scales=scales):
        port = nhwc(pm.inference_logits(nchw(x))[0])
    own = np.abs(jint8 - jfp).max()
    gap = np.abs(port - jint8).max()
    agree = (port.argmax(-1) == jint8.argmax(-1)).mean()
    print(f'int8 logits: port against JAX {gap:.3e}, JAX int8 against '
          f'fp32 {own:.3e}, argmax agreement {agree}')
    assert own > 0
    assert gap <= 0.1 * own, (gap, own)
    assert agree >= 0.99, agree


# --------------------------------- QAT ---------------------------------
def _qat_model_cfg():
    cfg = Config.fromfile(QAT)
    model = dict(tiny_model_cfg())
    for head in ('decode_head', 'auxiliary_head'):
        model[head] = dict(model[head], dropout_ratio=0.0,
                           num_classes=cfg.model[head]['num_classes'])
    return cfg, model


def test_qat_step_matches_jax():
    """One SGD step of the qat leaf config's model (tiny widths, dropout
    off) under ``qat_context_from_cfg(cfg)`` against the JAX step traced
    under ``qat_training``: log vars, and every parameter and BN statistic
    after the step (the running variance after torch's n/(n-1), ROADMAP
    C2)."""
    cfg, model_cfg = _qat_model_cfg()
    jmodel = jax_segmentor(model_cfg)
    variables = jax_variables(jmodel, (1, 64, 64, 3), seed=7)
    rs = np.random.RandomState(8)
    img = rs.uniform(0, 255, (2, 64, 64, 3)).astype(np.float32)
    gt = rs.randint(0, 6, (2, 64, 64)).astype(np.int32)
    gt[:, :3] = 255
    mean, std = [120.0, 110.0, 100.0], [60.0, 55.0, 58.0]
    tx = jax_opt.build_optimizer(SGD)
    jstate = UDATrainState(
        params=variables['params'], batch_stats=variables['batch_stats'],
        ema_params={}, ema_batch_stats={},
        opt_state=tx.init(variables['params']), step=jnp.zeros((), jnp.int32))
    step_fn = JaxTrainer(jmodel).make_train_step(tx, mean, std, jit=False)
    batch = {'img': img, 'gt_semantic_seg': gt}
    with two_pass_batch_variance(), jq.qat_context_from_cfg(cfg)():
        compiled = jax.jit(step_fn).lower(
            jstate, batch, jax.random.PRNGKey(0)).compile(FAST_COMPILE)
    new_state, ref_vars, _ = compiled(jstate, batch, jax.random.PRNGKey(0))

    algo = build_algorithm({'model': model_cfg}, device='cpu')
    state = algo.init_state(torch.Generator().manual_seed(0),
                            build_optimizer(SGD))
    load_port(state.student, variables).train()
    counts = {}
    hooks = [m.register_forward_hook(
        lambda mod, inp, out, n=n: counts.__setitem__(
            n, inp[0].numel() // inp[0].shape[1]))
        for n, m in state.student.named_modules()
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    with pq.qat_context_from_cfg(cfg)():
        state, got = algo.make_train_step(mean, std)(
            state, {'img': nchw(img), 'gt_semantic_seg': torch.from_numpy(gt)},
            torch.Generator().manual_seed(1))
    for hk in hooks:
        hk.remove()
    assert sorted(got) == sorted(ref_vars)
    for k in ref_vars:
        np.testing.assert_allclose(got[k].item(), float(ref_vars[k]),
                                   rtol=1e-3, atol=3e-5, err_msg=k)
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


def test_qat_context_from_cfg():
    """As ``tests/test_quant.py::test_qat_context_from_cfg`` holds the
    JAX function: nothing without ``qat`` or with ``enabled=False``; with
    ``True`` or a dict (its ``skip`` and ``act_scales`` read) a context
    that fake-quantizes."""
    assert pq.qat_context_from_cfg({}) is contextlib.nullcontext
    assert pq.qat_context_from_cfg(
        {'qat': dict(enabled=False)}) is contextlib.nullcontext
    assert pq.qat_context_from_cfg(object()) is contextlib.nullcontext
    layer = _Holder(torch.nn.Conv2d(4, 4, 1))
    x = torch.randn(1, 4, 5, 5)
    ref = layer.conv0(x)
    with pq.qat_context_from_cfg({'qat': True})():
        with pq.qat_training(skip=()):
            fake = layer.conv0(x)
    assert not torch.equal(fake, ref)
    ctx = pq.qat_context_from_cfg({'qat': dict(skip=('conv*',),
                                               act_scales={'a/b': 3.0})})
    with ctx():
        assert torch.equal(layer.conv0(x), ref)


# ------------------------------- BN folding ------------------------------
def test_fold_batch_norms_matches_jax_and_keeps_the_output(models):
    jm, v, pm, x = models['deeplabv3plus']
    want = jax_variables_to_state_dict(jax_fold(v), pm.state_dict(),
                                       **key_families(pm))
    folded = build_segmentor(dict(MODELS['deeplabv3plus'][0]))
    folded.load_state_dict(pm.state_dict())
    fold_batch_norms(folded.eval())
    got = folded.state_dict()
    changed = 0
    for k, w in want.items():
        if k.endswith('num_batches_tracked'):
            continue
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
        changed += not torch.equal(got[k], pm.state_dict()[k])
    assert changed > 50
    with torch.no_grad():
        ref = pm.inference_logits(nchw(x))[0]
        out = folded.inference_logits(nchw(x))[0]
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5 * float(ref.abs().max()))


# ------------------------------ the user path ----------------------------
def test_int8_eval_and_clis(models, tmp_path):
    """The tiny qat config on synthetic tiles: fp32 and int8 mIoU through
    ``single_gpu_test`` and ``tools/test_torch.py`` within 2 points; the
    port's and the JAX tool's tables of the same weights and image have
    the same keys and values, and each drives the port's CLI."""
    _, v, pm, _ = models['deeplabv3plus']
    root = str(tmp_path)
    make_synthetic_data_torch.main(['-o', osp.join(root, 'vaih'), '--size',
                                    '64', '--num-train', '1',
                                    '--num-val', '2', '--seed', '1'])
    cfg = Config.fromfile(QAT)
    cfg.model = dict(tiny_model_cfg())
    for key in ('val', 'test'):
        cfg.data[key]['data_root'] = osp.join(root, 'vaih')
        cfg.data[key]['pipeline'][1]['img_scale'] = (64, 64)
    cfg_path = osp.join(root, 'tiny_qat.py')
    cfg.dump(cfg_path)
    ckpt = osp.join(root, 'port.pth')
    torch.save({'state_dict': pm.state_dict()}, ckpt)
    params, stats, _ = convert_state_dict(pm.state_dict())
    jckpt = save_orbax(osp.join(root, 'jax'), 1,
                       {'params': params, 'batch_stats': stats})

    tables = {}
    for name, tool, extra in (('port', calibrate_int8_torch, ['--device',
                                                              'cpu']),
                              ('jax', calibrate_int8, [])):
        out = osp.join(root, f'{name}.json')
        tool.main([cfg_path, ckpt if name == 'port' else jckpt, '-o', out,
                   '-n', '1', '-p', '99.9', *extra])
        with open(out) as f:
            tables[name] = (out, json.load(f))
    assert set(tables['port'][1]) == set(tables['jax'][1])
    for k, want in tables['jax'][1].items():
        np.testing.assert_allclose(tables['port'][1][k], want, rtol=1e-5,
                                   err_msg=k)

    args = [cfg_path, ckpt, '--eval', 'mIoU', '--device', 'cpu']
    fp32 = test_torch.main(args)['mIoU']
    model = init_segmentor(cfg_path, ckpt, device='cpu')
    dataset = build_dataset({**cfg.data['test'], 'test_mode': True})
    results = single_gpu_test(model, build_dataloader(dataset, 1, 1,
                                                      shuffle=False),
                              quant_int8=True, progress=False)
    dynamic = dataset.evaluate(results, metric='mIoU',
                               logger='silent')['mIoU']
    assert abs(dynamic - fp32) <= 0.02, (dynamic, fp32)
    for name, (path, _) in tables.items():
        got = test_torch.main(args + ['--quant-int8', '--act-scales', path])
        assert abs(got['mIoU'] - fp32) <= 0.02, (name, got['mIoU'], fp32)
