"""The port's attention and context heads on the ResNet (DANet, NonLocal,
GCNet, DNL, APCNet, DMNet, EMANet, ISANet, CCNet, PSANet, EncNet), its
``psa_mask`` and ``Encoding`` ops and FastFCN's ``JPU`` neck against the
JAX package on the CPU.

The twelve ``configs/_base_/models`` defs at narrow widths: the ResNets
at depth 18 with 8 stem and base channels on 64^2 inputs (8^2 features),
ISANet on 72^2 (a 9^2 grid, padded to 12^2 by its 4 x 4 blocks); heads
at 16 channels, auxiliary heads at 8, 5 classes, no dropout; EMANet's
bases 8 of 16 channels, PSANet's mask 5 x 5 (displacements past its
window on the 4^2 shrunk grid), EncNet's 8 codes, the JPU 8 wide (the
PSP head built at its fed width, 32). Weights come from
``torch_parity.jax_variables`` through ``jax_variables_to_state_dict``,
which must fill every key; its draws make every ``gamma`` non-zero (the
JAX file's initial zeros would leave PAM's and CCNet's q, k and v without
a gradient), and the test gives the encoding's smoothing factors the
JAX file's range U[-1, 0). One JAX program a def computes the backbone's
taps, the neck's outputs, the heads' outputs (DANet's branch logits too),
the auxiliary logits and the segmentor's logits, shared by the tests and
across xdist's workers through ``torch_parity.shared_by_workers``; each
head is held on the JAX program's own inputs to it, each segmentor on the
image. PSAHead's modes (collect, distribute, bi-direction, each over
the mask and ``compact``; one without its softmax, with a normalization
factor and no shrink) are held alone on a 7^2 map, shrunk to 4^2 with
the JAX file's odd-size rounding.

At the configs' full widths, the port's state dict (built on the meta
device) is held key for key to the JAX tree's shapes (``jax.eval_shape``
of ``init``; nothing compiles); every JAX leaf has a key and no two keys
share a leaf.

Tolerances: ``test_torch_a13_heads.py``'s. Forward atol 1e-4, rtol 1e-4
(fp32 in another order); the step's log vars rtol 2e-4, atol 2e-5,
post-step parameters and EMANet's bases rtol 1e-3, atol 3e-5, BN
statistics rtol 2e-3, atol 2e-4 after the n/(n-1) gap of ROADMAP C2.
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
from pfst_tpu.models import build_head as jax_build_head  # noqa: E402
from pfst_tpu.models import build_segmentor as jax_segmentor  # noqa: E402
from pfst_tpu.models.uda.uda_decorator import UDATrainState  # noqa: E402
from pfst_tpu.ops.encoding import Encoding as JaxEncoding  # noqa: E402
from pfst_tpu.ops.psa_mask import psa_mask as jax_psa_mask  # noqa: E402
from pfst_tpu_torch.apis import build_algorithm  # noqa: E402
from pfst_tpu_torch.core import (build_optimizer,  # noqa: E402
                                 jax_variables_to_state_dict, param_paths)
from pfst_tpu_torch.core.convert import (head_prefix,  # noqa: E402
                                         key_families, torch_key_to_flax,
                                         uper_heads)
from pfst_tpu_torch.models import build_head, build_segmentor  # noqa: E402
from pfst_tpu_torch.ops import resize  # noqa: E402
from pfst_tpu_torch.ops.encoding import Encoding  # noqa: E402
from pfst_tpu_torch.ops.psa_mask import psa_mask  # noqa: E402
from pfst_tpu_torch.utils import Config  # noqa: E402

CONFIGS = osp.join(osp.dirname(__file__), '..', 'configs', '_base_',
                   'models')
TOL = dict(atol=1e-4, rtol=1e-4)
SGD = dict(type='SGD', lr=1e-2)
DEFS = ['danet_r50-d8', 'nonlocal_r50-d8', 'gcnet_r50-d8', 'dnl_r50-d8',
        'apcnet_r50-d8', 'dmnet_r50-d8', 'emanet_r50-d8', 'isanet_r50-d8',
        'ccnet_r50-d8', 'psanet_r50-d8', 'encnet_r50-d8',
        'fastfcn_r50-d32_jpu_psp']
SIZE = {'isanet_r50-d8': 72}
R18 = dict(depth=18, base_channels=8, stem_channels=8)
HEAD_KW = {'emanet_r50-d8': dict(ema_channels=16, num_bases=8),
           'isanet_r50-d8': dict(isa_channels=16, down_factor=(4, 4)),
           'psanet_r50-d8': dict(mask_size=(5, 5)),
           'encnet_r50-d8': dict(in_channels=(16, 32, 64), num_codes=8),
           'fastfcn_r50-d32_jpu_psp': dict(in_channels=32)}
NORM = dict(type='BN', requires_grad=True)


def _head(cfg, **kw):
    cfg.update(kw, dropout_ratio=0.0, num_classes=5)
    return cfg


def tiny_cfg(name):
    """A def of ``DEFS`` at narrow widths (module docstring)."""
    cfg = Config.fromfile(osp.join(CONFIGS, f'{name}.py')).to_dict()['model']
    cfg['backbone'].update(R18)
    if cfg.get('neck'):
        cfg['neck'].update(in_channels=(16, 32, 64), mid_channels=8)
    _head(cfg['decode_head'], **{'in_channels': 64, 'channels': 16,
                                 **HEAD_KW.get(name, {})})
    _head(cfg['auxiliary_head'], in_channels=32, channels=8)
    return cfg


def _size(name):
    return SIZE.get(name, 64)


def _images(rs, b, size):
    """Normal noise, each image shifted by its own offset (train-mode BN
    of a pooled branch normalizes one value per image)."""
    shift = np.linspace(-2.0, 2.0, b).reshape(b, 1, 1, 1)
    return (rs.randn(b, size, size, 3) + shift).astype(np.float32)


def _variables(jmodel, shape):
    """``jax_variables``, with EncNet's smoothing factors in the JAX
    file's U[-1, 0) (the draws put every other scale in [0.5, 1))."""
    variables = jax_variables(jmodel, shape)
    enc = variables['params'].get('decode_head_mod', {}).get('encoding')
    if enc is not None:
        rs = np.random.RandomState(9)
        enc['scale'] = rs.uniform(-1.0, 0.0, enc['scale'].shape).astype(
            np.float32)
    return variables


def _jax_reference(name):
    """The JAX model's variables, and on two seeded images its backbone
    taps, neck outputs, head outputs, auxiliary logits and the
    segmentor's logits (numpy)."""
    jmodel = jax_segmentor(copy.deepcopy(tiny_cfg(name)))
    size = _size(name)
    variables = _variables(jmodel, (1, size, size, 3))
    img = _images(np.random.RandomState(4), 2, size)

    def run(v, x):
        taps = jmodel.apply(v, x, method=lambda m, t: m.backbone_mod(t))
        out = jmodel.apply(v, x)
        logits, _ = jmodel.apply(v, x, method=jmodel.encode_decode)
        return dict(taps=taps, feats=out['feats'],
                    head=(out['seg_logits'], out['decoded_features'],
                          *out['branch_logits']),
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
                tmp_path_factory, f'context_heads_{name}',
                lambda: _jax_reference(name))
        return cache[name]
    return get


def _port(name, variables):
    return load_port(build_segmentor(tiny_cfg(name)), variables)


def _close(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(nhwc(g), w, **TOL)


# -------------------------------- the ops --------------------------------
@pytest.mark.parametrize('kind', ['collect', 'distribute'])
@pytest.mark.parametrize('mask_size', [(5, 5), (3, 5)])
def test_psa_mask_matches_jax(kind, mask_size):
    """The dense [k, q] attention of an over-complete mask on a 4 x 3
    grid, where both windows leave displacements out: equal to the JAX
    function's on its own inputs."""
    mh, mw = mask_size
    mask = np.random.RandomState(0).randn(2, 4, 3, mh * mw).astype(
        np.float32)
    want = np.asarray(jax_psa_mask(jnp.asarray(mask), mask_size, kind))
    got = psa_mask(nchw(mask), mask_size, kind)
    assert want.shape == (2, 12, 12) and (want == 0).any()
    np.testing.assert_array_equal(got.numpy(), want)


def test_psa_mask_gradient_reaches_the_window_once():
    """The gather's backward: each mask entry inside the grid gets the
    gradient of the one attention entry it fills."""
    mask = torch.randn(1, 9, 3, 3, requires_grad=True)
    psa_mask(mask, (3, 3), 'collect').sum().backward()
    # position (i, j) fills the displacements that stay on the 3 x 3 grid
    want = torch.zeros(1, 9, 3, 3)
    for di in range(3):
        for dj in range(3):
            want[0, di * 3 + dj, max(0, 1 - di):3 - max(0, di - 1),
                 max(0, 1 - dj):3 - max(0, dj - 1)] = 1
    torch.testing.assert_close(mask.grad, want, rtol=0, atol=0)


def test_psa_mask_table_made_in_inference_mode_serves_training():
    """A displacement table first built under ``torch.inference_mode`` (a
    request) is reused by a training call, which saves it for the
    backward."""
    with torch.inference_mode():
        psa_mask(torch.randn(1, 9, 5, 4), (3, 3), 'distribute')
    mask = torch.randn(1, 9, 5, 4, requires_grad=True)
    psa_mask(mask, (3, 3), 'distribute').sum().backward()
    # one for each pair of positions within one row and one column of
    # each other: (5 + 2 * 4) row pairs times (4 + 2 * 3) column pairs
    assert mask.grad.sum() == (5 + 2 * 4) * (4 + 2 * 3)


def test_encoding_matches_jax():
    """``Encoding`` on 50 features of 16 channels over 8 codewords, the
    smoothing factors in U[-1, 0): within 1e-4 of the JAX layer's."""
    rs = np.random.RandomState(1)
    x = rs.randn(2, 50, 16).astype(np.float32)
    jenc = JaxEncoding(16, 8)
    params = {'codewords': (0.3 * rs.randn(8, 16)).astype(np.float32),
              'scale': rs.uniform(-1.0, 0.0, 8).astype(np.float32)}
    want = run_jit(lambda p, t: jenc.apply({'params': p}, t), params, x)
    enc = Encoding(16, 8)
    enc.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    with torch.no_grad():
        got = enc(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ------------------------------ the modules ------------------------------
@pytest.mark.parametrize('name', DEFS)
def test_head_matches_jax(name, refs):
    """The decode head on the JAX program's own inputs to it (the
    backbone's taps, or the JPU's outputs): its logits and features, and
    DANet's PAM and CAM logits, within 1e-4 of the JAX head's."""
    r = refs(name)
    port = _port(name, r['variables'])
    with torch.no_grad():
        got = port.decode_head([nchw(f) for f in r['out']['feats']])
    _close(got, r['out']['head'])


def test_jpu_matches_jax(refs):
    """FastFCN's JPU on the JAX program's taps: the two levels it passes
    through and its 4 x 8 = 32-channel map at the first level's stride."""
    r = refs('fastfcn_r50-d32_jpu_psp')
    port = _port('fastfcn_r50-d32_jpu_psp', r['variables'])
    with torch.no_grad():
        got = port.neck([nchw(t) for t in r['out']['taps']])
    assert got[-1].shape[1:] == (32, 8, 8)
    _close(got, r['out']['feats'])


PSA_CASES = [('collect', False, {}), ('distribute', False, {}),
             ('bi-direction', False, {}), ('collect', True, {}),
             ('distribute', True, {}), ('bi-direction', True, {}),
             ('bi-direction', False, dict(psa_softmax=False,
                                          normalization_factor=4.0,
                                          shrink_factor=1))]


def _psa_cfg(psa_type, compact, extra):
    # 7^2 features shrink to 4^2 (both sides odd: rounded up, corners
    # aligned); compact masks address the 16 positions themselves
    shrink = extra.get('shrink_factor', 2)
    side = 4 if shrink == 2 else 7
    return dict(type='PSAHead', in_channels=16, in_index=3, channels=8,
                mask_size=(side, side) if compact else (5, 5),
                psa_type=psa_type, compact=compact, dropout_ratio=0.0,
                num_classes=5, norm_cfg=NORM, align_corners=False,
                **{'shrink_factor': 2, **extra})


@pytest.mark.parametrize('psa_type, compact, extra', PSA_CASES,
                         ids=lambda v: str(v).replace(' ', ''))
def test_psa_head_modes_match_jax(psa_type, compact, extra):
    """PSAHead in each mode on a 7^2 map, eval mode: logits and features
    within 1e-4 of the JAX head's."""
    cfg = _psa_cfg(psa_type, compact, extra)
    rs = np.random.RandomState(3)
    feats = tuple(rs.randn(2, s, s, c).astype(np.float32)
                  for c, s in ((4, 28), (8, 14), (8, 7), (16, 7)))
    jhead = jax_build_head(dict(cfg))
    variables = jax_variables(jhead, [f.shape for f in feats])
    want = run_jit(lambda v, x: jhead.apply(v, x), variables, feats)
    holder = torch.nn.Module()
    holder.decode_head = build_head(dict(cfg))
    load_port(holder, {k: {'decode_head_mod': v}
                       for k, v in variables.items()})
    with torch.no_grad():
        got = holder.decode_head([nchw(f) for f in feats])
    _close(got, [np.asarray(w) for w in want])


@pytest.mark.parametrize('name', DEFS)
def test_segmentor_matches_jax(name, refs):
    """The def's segmentor from its config: every key filled from the JAX
    tree, and its taps, neck outputs, head logits and features, the
    auxiliary logits and the resized logits (DANet's from its summed
    branch alone) within 1e-4."""
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
           [want['head'][0], want['head'][1], want['logits']])
    _close(out['aux_logits'], want['aux_logits'])
    assert states['decoded_features'].shape == out['decoded_features'].shape


def test_ema_bases_move_only_in_training(refs):
    """EMANet's bases: a buffer, in no optimizer group; an eval forward
    leaves it, a train forward moves it by the momentum update."""
    r = refs('emanet_r50-d8')
    port = _port('emanet_r50-d8', r['variables'])
    head = port.decode_head
    assert 'bases' not in dict(port.named_parameters()) and \
        'decode_head.bases' in port.state_dict()
    before = head.bases.clone()
    feats = [nchw(f) for f in r['out']['feats']]
    with torch.no_grad():
        head(feats)
        assert torch.equal(head.bases, before)
        head.train()(feats)
    assert not torch.allclose(head.bases, before)


# ------------------------------- the keys -------------------------------
def test_keys_of_the_context_heads(refs):
    """The heads' own modules under the JAX file's names: ConvModules,
    plain convs and Dense layers, the 0-d ``gamma``s, the LayerNorm, the
    encoding, EMANet's bases in ``batch_stats``, DANet's branch
    classifiers; the JPU by its class's family; the optimizer's paths
    follow them."""
    cases = [
        ('decode_head.pam_in.bn.running_var', 1,
         'batch_stats/decode_head_mod/pam_in/norm/bn/var'),
        ('decode_head.pam.q.weight', 4, 'params/decode_head_mod/pam/q/kernel'),
        ('decode_head.pam.gamma', 0, 'params/decode_head_mod/pam/gamma'),
        ('decode_head.cam_cls.conv_seg.bias', 1,
         'params/decode_head_mod/cam_cls/conv_seg/bias'),
        ('decode_head.conv_seg.weight', 4,
         'params/decode_head_mod/cls/conv_seg/kernel'),
        ('decode_head.gamma', 0, 'params/decode_head_mod/gamma'),
        ('decode_head.transform_ln.weight', 1,
         'params/decode_head_mod/transform_ln/scale'),
        ('decode_head.bases', 3, 'batch_stats/decode_head_mod/bases'),
        ('decode_head.global.v.weight', 2,
         'params/decode_head_mod/global/v/kernel'),
        ('decode_head.attention_p_mask.weight', 4,
         'params/decode_head_mod/attention_p_mask/kernel'),
        ('decode_head.encoding.scale', 1,
         'params/decode_head_mod/encoding/scale'),
        ('decode_head.pool_proj3.conv.weight', 4,
         'params/decode_head_mod/pool_proj3/conv/kernel'),
        ('decode_head.bottleneck.bn.weight', 1,
         'params/decode_head_mod/bottleneck/norm/bn/scale'),
        ('neck.dilated2.depthwise_conv.bn.bias', 1,
         'params/neck_mod/dilated2/depthwise_conv/norm/bn/bias')]
    for key, ndim, path in cases:
        coll, *path = path.split('/')
        assert torch_key_to_flax(key, ndim, neck='cnn') == (coll, path), key
    port = _port('danet_r50-d8', refs('danet_r50-d8')['variables'])
    paths = param_paths(port.named_parameters(), **key_families(port))
    assert paths['decode_head.cam.gamma'] == 'decode_head_mod/cam/gamma'
    assert paths['decode_head.pam_out.conv.weight'] == \
        'decode_head_mod/pam_out/conv/kernel'


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
    the port maps to a JAX leaf of its shape, no two keys to one leaf,
    and every leaf has a key (PSANet's 97^2-channel masks, EMANet's
    bases, EncNet's codewords among them)."""
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
    uper = uper_heads(sd)
    seen, bad, n = set(), [], 0
    for key, ref in sd.items():
        if key.endswith('num_batches_tracked'):
            continue
        n += 1
        mapped = torch_key_to_flax(key, ref.ndim, uper=head_prefix(key) in
                                   uper, **key_families(port))
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


def _near_ties(student, img, gt):
    """By loss prefix, the share (in points, as the accuracy counts) of
    labelled pixels whose two highest logits lie within the forward
    tolerance (1e-4) of each other in a train-mode forward of a copy of
    ``student`` on the step's batch: argmax ties that fp32 summed in
    another order may break either way."""
    student = copy.deepcopy(student)
    with torch.no_grad():
        out = student(img)
    heads = [('decode', out['seg_logits'])]
    names = getattr(student.decode_head, 'branch_loss_names', ())
    if names:
        heads = [(f'decode.{student.decode_head.primary_loss_name}',
                  out['seg_logits'])] + [
            (f'decode.{n}', lg) for n, lg in zip(names, out['branch_logits'])]
    heads += [('aux', lg) for lg in out['aux_logits']]
    valid = gt != 255
    share = {}
    for prefix, logits in heads:
        logits = resize(logits, size=gt.shape[1:], mode='bilinear',
                        align_corners=False)
        top2 = logits.topk(2, dim=1).values
        near = (top2[:, 0] - top2[:, 1] < TOL['atol']) & valid
        share[prefix] = 100.0 * float(near.sum()) / float(valid.sum())
    return share


STEP_KEYS = {'danet_r50-d8': {'decode.pam_cam.loss_ce', 'decode.pam.loss_ce',
                              'decode.cam.loss_ce', 'decode.cam.acc_seg'},
             'encnet_r50-d8': {'decode.loss_se', 'decode.loss_ce'},
             'emanet_r50-d8': {'decode.loss_ce'},
             'ccnet_r50-d8': {'decode.loss_ce'}}


@pytest.mark.parametrize('name', sorted(STEP_KEYS))
def test_supervised_sgd_step_matches_jax(name, refs):
    """One SGD step of ``SupervisedTrainer`` against the JAX trainer's
    from the same weights (every ``gamma`` non-zero) and batch: log vars
    (DANet's three branch losses, EncNet's SE loss) and every parameter,
    BN statistic and EMANet's bases after the step."""
    size = _size(name)
    variables = refs(name)['variables']
    gammas = [np.asarray(v) for p, v in jax.tree_util.tree_leaves_with_path(
        variables['params']) if p[-1].key == 'gamma']
    assert len(gammas) == {'danet_r50-d8': 2, 'ccnet_r50-d8': 1}.get(name, 0)
    assert all(g != 0 for g in gammas)
    rs = np.random.RandomState(6)
    img = _images(rs, 2, size)
    gt = rs.randint(0, 4, (2, size, size)).astype(np.int32)
    gt[:, :2] = 255
    mean, std = [120.0, 110.0, 100.0], [60.0, 55.0, 58.0]
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
        ties = ties_share.get(k[:-len('.acc_seg')], 0.0) \
            if k.endswith('.acc_seg') else 0.0
        np.testing.assert_allclose(got[k].item(), float(ref_vars[k]),
                                   rtol=2e-4, atol=2e-5 + ties, err_msg=k)
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
    if name == 'emanet_r50-d8':
        assert not torch.equal(template['decode_head.bases'],
                               before['decode_head.bases'])
