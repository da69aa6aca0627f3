"""Parity of the port's losses and of the similarity's backward with the
JAX package, on the same numpy-seeded inputs (NHWC on the JAX side, NCHW
in the port, on the CPU).

Tolerances: cross-entropy, accuracy and the masked statistics atol 1e-6
(fp32 sums in another order); ``PFGSTLoss`` values rtol 2e-4, atol 2e-6
and gradients atol 1e-5 * max(1, max|g|) (fp32 reductions over pixels
and channels in another order); the similarity backward atol
1e-5 * max(1, max|g|). ``torch.topk`` may order ties otherwise than
``jax.lax.top_k``; ties occur at border pixels only, which the target
mask drops, so the losses agree all the same.
"""
import numpy as np
import pytest
import torch

# torch's OpenMP pool must not run beside XLA-CPU in one process
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_pfgst_loss import WEIGHTS, make_tensors, to_nhwc  # noqa: E402
from torch_parity import run_jit  # noqa: E402

from pfst_tpu.models.losses.accuracy import accuracy as jax_accuracy  # noqa: E402
from pfst_tpu.models.losses import cross_entropy_loss as jax_ce  # noqa: E402
from pfst_tpu.models.losses import utils as jax_utils  # noqa: E402
from pfst_tpu.models.losses.pfgst_loss import PFGSTLoss as JaxPFGST  # noqa: E402
from pfst_tpu.ops.pallas_sim import xla_neighborhood_similarity  # noqa: E402
from pfst_tpu_torch import ops  # noqa: E402
from pfst_tpu_torch.models import build_loss  # noqa: E402
from pfst_tpu_torch.models.losses import (PFGSTLoss, accuracy,  # noqa: E402
                                          binary_cross_entropy,
                                          cross_entropy, masked_mean,
                                          masked_std, weight_reduce_loss)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _ce_inputs(seed=0):
    rs = np.random.RandomState(seed)
    logits = rs.randn(2, 9, 11, 5).astype(np.float32) * 2
    label = rs.randint(0, 5, (2, 9, 11)).astype(np.int64)
    label[0, :3] = 255
    label[1, 4, :6] = 255
    weight = rs.uniform(0, 1, (2, 9, 11)).astype(np.float32)
    return logits, label, weight


@pytest.mark.parametrize('pixel_weight', [False, True])
@pytest.mark.parametrize('class_weight', [None, [0.5, 1.0, 2.0, 1.5, 0.7]])
@pytest.mark.parametrize('avg_non_ignore', [False, True])
def test_cross_entropy_matches_jax(pixel_weight, class_weight,
                                   avg_non_ignore):
    logits, label, weight = _ce_inputs()
    w = weight if pixel_weight else None
    ref = jax_ce.cross_entropy(
        jnp.asarray(logits), jnp.asarray(label.astype(np.int32)),
        None if w is None else jnp.asarray(w), class_weight=class_weight,
        ignore_index=255, avg_non_ignore=avg_non_ignore)
    out = cross_entropy(_nchw(logits), torch.from_numpy(label),
                        None if w is None else torch.from_numpy(w),
                        class_weight=class_weight, ignore_index=255,
                        avg_non_ignore=avg_non_ignore)
    np.testing.assert_allclose(float(out), float(ref), atol=1e-6, rtol=0)
    # the config-facing loss: loss_weight, reduction override, the name
    cfg = dict(type='CrossEntropyLoss', loss_weight=0.4,
               class_weight=class_weight, avg_non_ignore=avg_non_ignore)
    loss_fn = build_loss(cfg)
    jax_fn = jax_ce.CrossEntropyLoss(**{k: v for k, v in cfg.items()
                                        if k != 'type'})
    assert loss_fn.loss_name == 'loss_ce'
    for red in (None, 'none'):
        got = loss_fn(_nchw(logits), torch.from_numpy(label),
                      None if w is None else torch.from_numpy(w),
                      reduction_override=red, ignore_index=255)
        want = jax_fn(jnp.asarray(logits),
                      jnp.asarray(label.astype(np.int32)),
                      None if w is None else jnp.asarray(w),
                      reduction_override=red, ignore_index=255)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-6, rtol=0)


@pytest.mark.parametrize('channels', [1, 5])
def test_binary_cross_entropy_matches_jax(channels):
    logits, label, weight = _ce_inputs(1)
    logits = logits[..., :channels]
    if channels == 1:
        label = np.where(label == 255, 255, label % 2)
    ref = jax_ce.binary_cross_entropy(
        jnp.asarray(logits), jnp.asarray(label.astype(np.int32)),
        jnp.asarray(weight), ignore_index=255, avg_non_ignore=True)
    out = binary_cross_entropy(_nchw(logits), torch.from_numpy(label),
                               torch.from_numpy(weight), ignore_index=255,
                               avg_non_ignore=True)
    np.testing.assert_allclose(float(out), float(ref), atol=1e-6, rtol=0)


@pytest.mark.parametrize('ignore_index,thresh,topk', [
    (255, None, 1), (None, None, 1), (255, 0.5, 1), (255, None, 2)])
def test_accuracy_matches_jax(ignore_index, thresh, topk):
    logits, label, _ = _ce_inputs(2)
    ref = jax_accuracy(jnp.asarray(logits), jnp.asarray(label), topk=topk,
                       thresh=thresh, ignore_index=ignore_index)
    out = accuracy(_nchw(logits), torch.from_numpy(label), topk=topk,
                   thresh=thresh, ignore_index=ignore_index)
    np.testing.assert_allclose(float(out), float(ref), atol=1e-6, rtol=0)


def test_masked_statistics_and_reduction_match_jax():
    rs = np.random.RandomState(3)
    x = rs.randn(2, 9, 7, 5).astype(np.float32)
    for mask in (rs.rand(2, 9, 7, 5) > 0.6, np.zeros((2, 9, 7, 5), bool),
                 np.eye(1, 630, 17, dtype=bool).reshape(2, 9, 7, 5)):
        xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
        xj, mj = jnp.asarray(x), jnp.asarray(mask)
        np.testing.assert_allclose(float(masked_mean(xt, mt)),
                                   float(jax_utils.masked_mean(xj, mj)),
                                   atol=1e-6, rtol=0)
        for unbiased in (True, False):
            np.testing.assert_allclose(
                float(masked_std(xt, mt, unbiased)),
                float(jax_utils.masked_std(xj, mj, unbiased)),
                atol=1e-6, rtol=0)
    # sums of 630 fp32 terms in another order: rtol 1e-5
    w = rs.rand(2, 9, 7, 5).astype(np.float32)
    for red, avg in (('mean', None), ('sum', None), ('mean', 17.0)):
        np.testing.assert_allclose(
            float(weight_reduce_loss(torch.from_numpy(x),
                                     torch.from_numpy(w), red, avg)),
            float(jax_utils.weight_reduce_loss(jnp.asarray(x),
                                               jnp.asarray(w), red, avg)),
            atol=1e-6, rtol=1e-5)


# -------------------------------- PFGSTLoss --------------------------------
_PFGST_CASES = {
    'cosine-top3-ds0.5': dict(sim_type='cosine', top_k=3, downscale=0.5),
    'cosine-all': dict(sim_type='cosine', top_k=None, downscale=None),
    'gaussian-top3': dict(sim_type='gaussian', top_k=3, downscale=None),
    'margin': dict(sim_type='cosine', top_k=3, src_loss_type='margin',
                   detach_unfold=False),
    'margin2-src_perc': dict(sim_type='cosine', top_k=3,
                             src_loss_type='margin2', src_perc=0.5),
    'src_perc': dict(sim_type='gaussian', top_k=3, src_perc=0.3),
    'ema-mismatched': dict(sim_type='cosine', top_k=3, dilation=1,
                           cross_prob_type='ema', downscale=None),
    # the Inria and SeasonNet configs' settings, at their class counts
    'inria-2cls-ds0.5': dict(sim_type='cosine', top_k=3, downscale=0.5,
                             classes=2),
    'season_net-33cls-ds1': dict(sim_type='cosine', top_k=3, downscale=1,
                                 classes=33),
}


@pytest.mark.parametrize('case', sorted(_PFGST_CASES))
def test_pfgst_loss_and_gradients_match_jax(case):
    kw = dict(top_k=3, dilation=2, kernel_size=3, weights=WEIGHTS,
              sigma=30, feat_level=None, detach_unfold=True)
    kw.update(_PFGST_CASES[case])
    t = make_tensors(np.random.RandomState(0), C=kw.pop('classes', 6))
    tt = {k: torch.from_numpy(v) for k, v in t.items()}
    x_src = tt['x_src'].requires_grad_()
    logits_trg = tt['logits_trg'].requires_grad_()
    out = PFGSTLoss(**kw)({**tt, 'x_src': x_src, 'logits_trg': logits_trg})
    names = sorted(out)
    # a weighted sum, so that no term's gradient can hide behind another's
    coef = {n: 1.0 + i for i, n in enumerate(names)}
    tj = to_nhwc(t)

    def jax_total(x_src, logits_trg):
        out = JaxPFGST(**kw)({**tj, 'x_src': x_src,
                              'logits_trg': logits_trg})
        out = {n: v for n, v in out.items() if n.startswith('loss')}
        return sum(coef[n] * out[n] for n in names), out

    (_, ref), ref_grads = run_jit(jax.value_and_grad(
        jax_total, argnums=(0, 1), has_aux=True), tj['x_src'],
        tj['logits_trg'])
    assert sorted(ref) == names
    for n in names:
        np.testing.assert_allclose(out[n].item(), float(ref[n]), rtol=2e-4,
                                   atol=2e-6, err_msg=n)
    sum(coef[n] * out[n] for n in names).backward()
    for got, want in zip((x_src.grad, logits_trg.grad), ref_grads):
        want = np.asarray(want)
        np.testing.assert_allclose(
            _nhwc(got), want, rtol=0,
            atol=1e-5 * max(1.0, float(np.abs(want).max())))
    if case == 'cosine-top3-ds0.5':
        assert float(np.abs(np.asarray(ref_grads[1])).max()) > 0


def test_pfgst_loss_rejects_what_it_does_not_have():
    with pytest.raises(NotImplementedError):
        PFGSTLoss(proj_net_cfg=dict(type='Conv'))
    with pytest.raises(ValueError):
        PFGSTLoss(sim_type='l2')
    with pytest.raises(ValueError):
        PFGSTLoss(cross_prob_type='src')


# ------------------------- similarity backward ----------------------------
def _sim_inputs(k, shape=(2, 10, 12, 16)):
    """x (B, H, W, C) and dL/dsim (B, H, W, k*k)."""
    rs = np.random.RandomState(k)
    # no exact zero vector: there the JAX VJP is NaN (ROADMAP C2)
    x = (rs.randn(*shape) * 0.7).astype(np.float32)
    g = rs.randn(*shape[:3], k * k).astype(np.float32)
    return x, g


@pytest.mark.parametrize('sim_type', ['cosine', 'gaussian'])
@pytest.mark.parametrize('k,d', [(3, 1), (3, 2), (5, 1), (5, 2), (7, 2),
                                 (3, 33)])
def test_similarity_backward_matches_jax_vjp(k, d, sim_type):
    """The plain gather backward (the backward kernel's oracle on the
    card) and autograd of the plain forward, each against ``jax.vjp`` of
    the XLA formula, at the geometries where the kernel branches (k = 7
    with one output row a block; d > 32 with its windows side by side, on
    a 40 x 70 map so that they hold in-map neighbors); the border pixels
    read zero padding."""
    x, g = _sim_inputs(k, (2, 40, 70, 6) if d > 32 else (2, 10, 12, 16))
    ref = np.asarray(run_jit(lambda t, ct: jax.vjp(
        lambda u: xla_neighborhood_similarity(u, k, d, sim_type=sim_type,
                                              sigma=4.0), t)[1](ct)[0],
        jnp.asarray(x), jnp.asarray(g)))
    tol = 1e-5 * max(1.0, float(np.abs(ref).max()))
    xt, gt = _nchw(x).requires_grad_(), _nchw(g)
    sim = ops.neighborhood_similarity(xt, k, d, sim_type=sim_type,
                                      sigma=4.0)
    (auto,) = torch.autograd.grad(sim, xt, gt)
    plain = ops.torch_neighborhood_similarity_backward(
        xt.detach(), sim.detach(), gt, k, d, sim_type=sim_type, sigma=4.0)
    assert plain.dtype == torch.float32 and plain.shape == xt.shape
    np.testing.assert_allclose(_nhwc(auto), ref, atol=tol, rtol=0)
    np.testing.assert_allclose(_nhwc(plain), ref, atol=tol, rtol=0)


def test_plain_backward_returns_input_dtype():
    x, g = _sim_inputs(3)
    xb = _nchw(x).bfloat16()
    sim = ops.torch_neighborhood_similarity(xb, 3, 2)
    out = ops.torch_neighborhood_similarity_backward(xb, sim, _nchw(g), 3, 2)
    ref = ops.torch_neighborhood_similarity_backward(xb.float(), sim,
                                                     _nchw(g), 3, 2)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, ref.bfloat16())


def test_backward_kernel_wrapper_refuses_cpu_tensors():
    x = torch.zeros(1, 4, 6, 6)
    sim = torch.zeros(1, 9, 6, 6)
    launches = ops.cuda_neighborhood_similarity_backward.launches
    with pytest.raises(ValueError, match='CUDA tensor'):
        ops.cuda_neighborhood_similarity_backward(x, sim, sim, 3, 2)
    assert ops.cuda_neighborhood_similarity_backward.launches == launches
