"""The port's bf16 path against the JAX package's bf16 path, on the CPU
(ROADMAP C4).

Both sides take ``dtype='bfloat16'`` from the model config. The port runs
it as torch autocast with fp32 parameters (norms, softmax and the losses
in fp32, the similarity widening bf16 features to fp32); the JAX package
as flax modules with a bf16 compute dtype (bf16 through the norms). Each
side runs the same weights (``torch_parity.jax_variables``, through
``jax_variables_to_state_dict``) on the same inputs (numpy, seeded), in
bf16 and in fp32:

* the tiny leaf config (``conftest.tiny_model_cfg``, the DeepLabV3+ head
  on a narrow ResNet, 48 x 48 input: a 6 x 6 head map, the least on which
  a dilated 3 x 3 window lies wholly in the target part of a ClassMix
  image, so that the sim losses are not gated off) and a tiny ViT
  UPerNet (2 layers, 2 heads of 32, 32 x 32 input): the logits and the
  decoded features;
* for the leaf config also the six PFGST loss values of the leaf
  config's ``PFGSTLoss`` (k 3, d 2, top 3, cosine) on what one step feeds
  it: the decoded features of the source images, the teacher's features
  and logits on the target images (the same weights) and the head-
  resolution logits of the ClassMix images.

The bounds. With P16, P32 the port's bf16 and fp32 outputs and J16, J32
JAX's, for each tensor (or loss value), C = 1.5:

1. max|P16 - J32| <= C max|J16 - J32| + max|P32 - J32|: the port's bf16
   output is no further from the reference's fp32 output than the
   reference's own bf16 output is, up to C and the fp32 parity gap (which
   the fp32 parity tests hold). The port rounds at fewer points than the
   JAX package (its norms, softmax and losses stay in fp32), so its own
   distance is about JAX's or less (measured: at most 1.12 times).
2. max|P16 - J16| <= C max(max|P16 - P32|, max|J16 - J32|) + the fp32
   gap: the two bf16 outputs part by no more than C times the larger of
   the two own distances. The triangle inequality alone gives twice it;
   two paths that round at different points part by about the larger
   (measured: at most 1.30 times).
3. each side's own distance is within OWN = 2^-5 of its fp32 output's
   largest magnitude (for a loss value, of the value): measured at most
   1.6 %, about eight roundings of 2^-9.

None of the three follows from the others or from the triangle
inequality. A control holds the bounds to a path that is wrong: the
port with every convolution's and linear layer's output rounded to 7
significant bits, one fewer than bf16 keeps, must break bound 1 (its
distance to J32 is 1.6 to 2.8 times JAX's own).
"""
import numpy as np
import pytest
import torch

# torch's OpenMP pool must not run beside XLA-CPU in one process
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from conftest import tiny_model_cfg  # noqa: E402
from test_pfgst_loss import WEIGHTS  # noqa: E402
from test_torch_vit import tiny_vit_cfg  # noqa: E402
from torch_parity import (jax_variables, load_port, nchw, nhwc,  # noqa: E402
                          run_jit)

from pfst_tpu.models import build_segmentor as jax_segmentor  # noqa: E402
from pfst_tpu.models.losses.pfgst_loss import \
    PFGSTLoss as JaxPFGST  # noqa: E402
from pfst_tpu_torch.models import build_segmentor  # noqa: E402
from pfst_tpu_torch.models.losses import PFGSTLoss  # noqa: E402

SIZE = {'leaf': 48, 'vit': 32}
B = 2
LOSS = dict(kernel_size=3, dilation=2, top_k=3, weights=WEIGHTS,
            sim_type='cosine', feat_level=None, detach_unfold=True)
C = 1.5  # bounds 1 and 2 of the module docstring
OWN = 2.0**-5  # bound 3: each side's bf16-vs-fp32 distance, relative
CONTROL_BITS = 7  # the control's significant bits (bf16 keeps 8)


def _leaf_cfg():
    cfg = tiny_model_cfg()
    cfg['decode_head']['dropout_ratio'] = 0.0
    cfg['auxiliary_head']['dropout_ratio'] = 0.0
    return cfg


def _vit_cfg():
    cfg = tiny_vit_cfg(img_size=SIZE['vit'], embed=64)
    cfg['backbone'].update(num_layers=2, out_indices=(0, 1))
    cfg['neck'].update(in_channels=(64, 64), scales=(2, 1))
    cfg['decode_head'].update(in_channels=(16, 16), in_index=(0, 1))
    cfg['auxiliary_head'].update(in_index=1)
    return cfg


def _inputs(rs, size):
    """Source, target and ClassMix images (NHWC), source labels and the
    mix masks (1 = source pixel: the top-left head-map pixel, so that
    windows wholly in the target part survive)."""
    src = rs.randn(B, size, size, 3).astype(np.float32)
    trg = rs.randn(B, size, size, 3).astype(np.float32)
    mask = np.zeros((B, size, size), np.float32)
    mask[:, :size // 6, :size // 6] = 1
    mixed = np.where(mask[..., None] > 0, src, trg).astype(np.float32)
    gt = rs.randint(0, 6, (B, size, size)).astype(np.int32)
    gt[0, :4] = 255
    return np.concatenate([src, trg, mixed]), gt, mask


def _jax_side(cfg, variables, imgs, gt, mask, dtype):
    """Logits and decoded features of ``imgs`` (and the PFGST losses)
    from the JAX package, in ``dtype``, as fp32 numpy (NHWC)."""
    jmodel = jax_segmentor(dict(cfg, dtype=dtype))

    def fn(v, x):
        out, states = jmodel.apply(v, x, method=jmodel.encode_decode)
        dec, head = states['decoded_features'], states['head_logits']
        losses = None
        if gt is not None:
            losses = JaxPFGST(**LOSS)(dict(
                x_src=dec[:B], x_ema=dec[B:2 * B], logits_ema=out[B:2 * B],
                logits_trg=head[2 * B:], gt_src=jnp.asarray(gt),
                mix_masks=jnp.asarray(mask)))
            losses = {k: v_ for k, v_ in losses.items()
                      if k.startswith('loss')}
        return out, dec, losses
    out, dec, losses = run_jit(fn, variables, imgs)
    return (np.asarray(out, np.float32), np.asarray(dec, np.float32),
            None if losses is None else
            {k: float(v) for k, v in losses.items()})


def _round_output(bits):
    """Forward hook rounding a module's output to ``bits`` significant
    bits (the control of the module docstring)."""
    def hook(module, args, out):
        m, e = torch.frexp(out.float())
        return torch.ldexp(torch.round(m * 2**bits) / 2**bits, e).to(out.dtype)
    return hook


def _port_side(cfg, variables, imgs, gt, mask, dtype, control=False):
    """The same from the port (NCHW in, NHWC fp32 numpy out); with
    ``control``, every convolution's and linear layer's output rounded to
    ``CONTROL_BITS`` significant bits."""
    port = load_port(build_segmentor(dict(cfg, dtype=dtype)), variables)
    if control:
        for m in port.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
                m.register_forward_hook(_round_output(CONTROL_BITS))
    with torch.no_grad():
        out, states = port.encode_decode(nchw(imgs))
        dec, head = states['decoded_features'], states['head_logits']
        losses = None
        if gt is not None:
            losses = PFGSTLoss(**LOSS)(dict(
                x_src=dec[:B], x_ema=dec[B:2 * B], logits_ema=out[B:2 * B],
                logits_trg=head[2 * B:], gt_src=torch.from_numpy(gt).long(),
                mix_masks=torch.from_numpy(mask)))
            losses = {k: float(v) for k, v in losses.items()
                      if k.startswith('loss')}
    return nhwc(out), nhwc(dec), losses


def _violations(name, p16, p32, j16, j32):
    """The bounds of the module docstring for one tensor (or loss value):
    prints the distances, returns the bounds broken."""
    p16, p32, j16, j32 = (np.asarray(x, np.float64)
                          for x in (p16, p32, j16, j32))
    assert p16.shape == p32.shape == j16.shape == j32.shape, name
    for x in (p16, j16):
        assert np.isfinite(x).all(), name

    def dist(a, b):
        return float(np.abs(a - b).max())
    to_ref, gap = dist(p16, j32), dist(p16, j16)
    own_port, own_jax = dist(p16, p32), dist(j16, j32)
    fp32_gap = dist(p32, j32)
    scale = max(float(np.abs(p32).max()), float(np.abs(j32).max()))
    print(f'{name}: port bf16 to JAX fp32 {to_ref:.3e}, bf16 gap {gap:.3e}; '
          f'port bf16-fp32 {own_port:.3e}, JAX bf16-fp32 {own_jax:.3e}, '
          f'fp32 gap {fp32_gap:.3e}; scale {scale:.3e}')
    broken = []
    if not to_ref <= C * own_jax + fp32_gap:
        broken.append(f'{name}: bound 1, {to_ref:.3e} > {C} x {own_jax:.3e}')
    if not gap <= C * max(own_port, own_jax) + fp32_gap:
        broken.append(f'{name}: bound 2, {gap:.3e} > {C} x '
                      f'{max(own_port, own_jax):.3e}')
    if not max(own_port, own_jax) <= OWN * scale:
        broken.append(f'{name}: bound 3, {own_port:.3e} / {own_jax:.3e} > '
                      f'{OWN} x {scale:.3e}')
    return broken


@pytest.mark.parametrize('model', ['leaf', 'vit'])
def test_bf16_path_is_held_to_jax_bf16(model):
    cfg = _leaf_cfg() if model == 'leaf' else _vit_cfg()
    size = SIZE[model]
    variables = jax_variables(jax_segmentor(cfg), (1, size, size, 3))
    imgs, gt, mask = _inputs(np.random.RandomState(5), size)
    if model == 'vit':
        gt = mask = None
    side = {(who, dt): fn(cfg, variables, imgs, gt, mask, dt)
            for who, fn in (('port', _port_side), ('jax', _jax_side))
            for dt in ('bfloat16', 'float32')}
    assert side['port', 'bfloat16'][0].dtype == np.float32
    rest = [side[k] for k in (('port', 'float32'), ('jax', 'bfloat16'),
                              ('jax', 'float32'))]
    control = _port_side(cfg, variables, imgs, None, None, 'bfloat16',
                         control=True)
    broken, caught = [], []
    for i, name in enumerate(('logits', 'decoded features')):
        broken += _violations(f'{model} {name}', side['port', 'bfloat16'][i],
                              *(r[i] for r in rest))
        caught += _violations(f'{model} {name} (control)', control[i],
                              *(r[i] for r in rest))
    if gt is not None:
        losses = {k: side[k][2] for k in side}
        names = sorted(losses['jax', 'float32'])
        assert len(names) == 6 and all(sorted(v) == names
                                       for v in losses.values())
        assert losses['jax', 'float32']['loss_sim_pos'] != 0.0
        for n in names:
            broken += _violations(f'{model} {n}', *(losses[k][n] for k in (
                ('port', 'bfloat16'), ('port', 'float32'),
                ('jax', 'bfloat16'), ('jax', 'float32'))))
    assert not broken, broken
    # the control, a path one bit short of bf16, must break bound 1
    assert any('bound 1' in c for c in caught), caught
