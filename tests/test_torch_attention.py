"""The port's attention (``pfst_tpu_torch/ops/attention.py``) against the
JAX references, on the CPU.

The Pallas TPU flash kernel that ``tools/attn_microbench.py::flash`` calls
cannot run here, so the JAX side is the microbench's ``naive`` and the
flash library's own reference, ``mha_reference``, whose custom VJP
(``flash_attention.py:1530-1705``) is the library's reference for its
backward. That VJP takes only ``sm_scale == 1``, so the scale is folded
into q and the gradient taken with respect to the unscaled q. The CUDA
kernels are held to the same plain versions on the card by
``chip_smoke.py`` (phase 3c).

Tolerances: fp32 forward and backward 1e-5 (the same formula, sums in
another order); bf16 input: the output's bf16 rounding and that of P,
both rounded to nearest (2^-9 relative each), so 2^-7 max|ref|.

Phase 3c's own check, ``chip_smoke.flash_allowances`` and
``flash_excess``, is held here to the plain versions run in bf16, which
round P, P^T, dS s and dS^T s where the bf16 kernels do; and the plain
bf16 backward to a jnp transcription of the TPU kernels' own formulas,
which scale dS before they round it. A model of the fp32 dQ kernel's
3xTF32 products (hi and lo formed on the int32 view as the kernel forms
them) is held to fp64 within phase 3c's bound, which 1xTF32 breaks.
"""
import functools
import os.path as osp
import sys

import numpy as np
import pytest
import torch

# torch's OpenMP pool must not run beside XLA-CPU in one process
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas.ops.tpu.flash_attention import \
    mha_reference  # noqa: E402

from pfst_tpu_torch.ops import (attention, cuda_flash_attention,  # noqa: E402
                                cuda_flash_attention_bwd_dkv,
                                cuda_flash_attention_bwd_dq, torch_attention,
                                torch_attention_backward)

sys.path.insert(0, osp.join(osp.dirname(__file__), '..', 'tools'))
sys.path.insert(0, osp.join(osp.dirname(__file__), '..'))
import attn_microbench  # noqa: E402
import attn_microbench_torch  # noqa: E402
import chip_smoke  # noqa: E402
from pfst_tpu_torch.ops.attention import _aligned  # noqa: E402

SHAPES = [(2, 3, 37, 16), (1, 2, 65, 32)]


def _qkvg(shape, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randn(*shape).astype(np.float32) for _ in range(4)]


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize('shape', SHAPES)
def test_forward_matches_naive_and_mha_reference(shape):
    q, k, v, _ = _qkvg(shape)
    scale = shape[-1]**-0.5
    out, lse = torch_attention(*_t(q, k, v), scale, return_lse=True)
    naive = attn_microbench.naive(q, k, v, scale)
    ref = mha_reference(q, k, v, None, sm_scale=scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(naive), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)
    s = np.einsum('bhqd,bhkd->bhqk', q, k).astype(np.float64) * scale
    np.testing.assert_allclose(
        lse.numpy(), np.log(np.exp(s).sum(-1)), rtol=1e-6)


def test_bf16_forward_matches_naive():
    """bf16 q, k, v: both sides round P to bf16 and the output to bf16."""
    shape = (2, 3, 37, 16)
    q, k, v, _ = [a.astype(jnp.bfloat16) for a in _qkvg(shape, 1)]
    scale = shape[-1]**-0.5
    naive = np.asarray(attn_microbench.naive(q, k, v, scale)
                       .astype(jnp.float32))
    tq, tk, tv = [torch.from_numpy(np.asarray(a.astype(jnp.float32)))
                  .to(torch.bfloat16) for a in (q, k, v)]
    out = torch_attention(tq, tk, tv, scale)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), naive, rtol=0,
                               atol=2.0**-7 * np.abs(naive).max())


@pytest.mark.parametrize('shape', SHAPES)
def test_backward_matches_mha_reference_and_autograd(shape):
    q, k, v, g = _qkvg(shape, 2)
    scale = shape[-1]**-0.5
    _, vjp = jax.vjp(
        lambda q_, k_, v_: mha_reference(q_ * scale, k_, v_, None,
                                         sm_scale=1.0), q, k, v)
    ref = [np.asarray(r) for r in vjp(jnp.asarray(g))]
    tq, tk, tv, tg = _t(q, k, v, g)
    o, lse = torch_attention(tq, tk, tv, scale, return_lse=True)
    plain = torch_attention_backward(tq, tk, tv, o, lse, tg, scale)
    xs = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    auto = torch.autograd.grad(torch_attention(*xs, scale), xs, tg)
    for name, p, a, r in zip('qkv', plain, auto, ref):
        np.testing.assert_allclose(p.numpy(), r, atol=1e-5, rtol=1e-5,
                                   err_msg=f'd{name} vs mha_reference')
        np.testing.assert_allclose(p.numpy(), a.numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=f'd{name} vs autograd')


def test_attention_on_cpu_is_the_plain_version_under_autograd():
    shape = (1, 2, 17, 32)
    q, k, v, g = _t(*_qkvg(shape, 3))
    scale = shape[-1]**-0.5
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    out = attention(*xs, scale)
    o, lse = torch_attention(q, k, v, scale, return_lse=True)
    torch.testing.assert_close(out.detach(), o, rtol=0, atol=0)
    grads = torch.autograd.grad(out, xs, g)
    for got, want in zip(grads, torch_attention_backward(q, k, v, o, lse, g,
                                                         scale)):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_kernels_take_cuda_tensors_only():
    """On a CPU tensor the wrappers raise; they never fall back."""
    q, k, v, g = _t(*_qkvg((1, 2, 17, 64), 4))
    stats = torch.zeros((1, 2, 17))
    with pytest.raises(ValueError, match='CUDA'):
        cuda_flash_attention(q, k, v, 0.125)
    with pytest.raises(ValueError, match='CUDA'):
        cuda_flash_attention_bwd_dkv(q, k, v, g, stats, stats, 0.125)
    with pytest.raises(ValueError, match='CUDA'):
        cuda_flash_attention_bwd_dq(q, k, v, g, stats, stats, 0.125)
    q48 = torch.zeros((1, 2, 17, 48))
    with pytest.raises(ValueError, match='head dimension'):
        cuda_flash_attention(q48, q48, q48, 0.125)
    with pytest.raises(TypeError, match='float32 or bfloat16'):
        cuda_flash_attention(q.half(), k.half(), v.half(), 0.125)
    with pytest.raises(ValueError, match='one .B, H, N, D. shape'):
        attention(q, k[:, :, :5], v, 0.125)
    meta = torch.empty((1, 2, 17, 64), device='meta')
    with pytest.raises(ValueError, match='no attention for meta'):
        attention(meta, meta, meta, 0.125)


# keys and values shorter or longer than the queries (MiT's and Twins'
# spatial-reduction attention): (N_q, N_k)
KV_LENGTHS = [(17, 1), (17, 16), (17, 49), (64, 1), (64, 16), (64, 49),
              (17, 64)]


@pytest.mark.parametrize('with_ab', [False, True], ids=['no-ab', 'ab'])
@pytest.mark.parametrize('nq, nk', KV_LENGTHS)
def test_plain_versions_with_nk_other_than_nq_match_mha_reference(nq, nk,
                                                                  with_ab):
    """q (B, H, N_q, D) against k, v (B, H, N_k, D), with and without a
    (B, H, N_q, N_k) ``ab``: the forward, its LSE and the backward (dab
    included) against the library's ``mha_reference`` and its VJP (scale
    folded into q and ab), and against autograd of the plain forward,
    within 1e-5."""
    b, h, d = 2, 3, 16
    rs = np.random.RandomState(nq * 100 + nk)
    q, g = (rs.randn(b, h, nq, d).astype(np.float32) for _ in range(2))
    k, v = (rs.randn(b, h, nk, d).astype(np.float32) for _ in range(2))
    ab = (rs.randn(b, h, nq, nk) * 3.0).astype(np.float32) if with_ab \
        else None
    scale = d**-0.5
    tq, tk, tv, tg = _t(q, k, v, g)
    tab = None if ab is None else torch.from_numpy(ab)
    out, lse = torch_attention(tq, tk, tv, scale, return_lse=True, ab=tab)
    assert out.shape == (b, h, nq, d) and lse.shape == (b, h, nq)
    ref = mha_reference(q, k, v, ab, sm_scale=scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)
    s = np.einsum('bhqd,bhkd->bhqk', q, k).astype(np.float64)
    s = (s if ab is None else s + ab) * scale
    np.testing.assert_allclose(lse.numpy(), np.log(np.exp(s).sum(-1)),
                               rtol=1e-6, atol=1e-6)
    args = (q, k, v) if ab is None else (q, k, v, ab)
    _, vjp = jax.vjp(lambda q_, k_, v_, *ab_: mha_reference(
        q_ * scale, k_, v_, ab_[0] * scale if ab_ else None, sm_scale=1.0),
        *args)
    want = [np.asarray(r) for r in vjp(jnp.asarray(g))]
    got = torch_attention_backward(tq, tk, tv, out, lse, tg, scale, ab=tab)
    xs = [t.clone().requires_grad_() for t in (tq, tk, tv)] + (
        [] if tab is None else [tab.clone().requires_grad_()])
    auto = torch.autograd.grad(attention(*xs[:3], scale, *xs[3:]), xs, tg)
    assert len(got) == len(want) == len(auto) == len(args)
    for name, x, a, r in zip(('dq', 'dk', 'dv', 'dab'), got, auto, want):
        assert x.shape == a.shape == r.shape, name
        np.testing.assert_allclose(x.numpy(), r, atol=1e-5, rtol=1e-5,
                                   err_msg=f'{name} vs mha_reference')
        np.testing.assert_allclose(x.numpy(), a.numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=f'{name} vs autograd')


def test_check_args_refuses_mismatched_kv_and_bias():
    """k and v must share their N_k; ``ab`` must be (1 or B, H, N_q,
    N_k): one of (., H, N_q, N_q) is refused when N_k != N_q; heads and
    head widths must match q's."""
    q = torch.zeros(2, 3, 17, 32)
    k = torch.zeros(2, 3, 4, 32)
    with pytest.raises(ValueError, match='one .B, H, N_k, D. shape'):
        attention(q, k, torch.zeros(2, 3, 5, 32), 0.125)
    for bad in (torch.zeros(2, 2, 4, 32), torch.zeros(2, 3, 4, 16)):
        with pytest.raises(ValueError, match='one .B, H, N_k, D. shape'):
            attention(q, bad, bad, 0.125)
    for ab in (torch.zeros(2, 3, 17, 17), torch.zeros(1, 3, 4, 17)):
        with pytest.raises(ValueError, match=r'ab must be \(2 or 1, 3, 17, '
                                             r'4\)'):
            attention(q, k, k, 0.125, ab)
    out = attention(q, k, k, 0.125, torch.zeros(1, 3, 17, 4))
    assert out.shape == q.shape


def test_kernels_refuse_cpu_tensors_with_nk_other_than_nq():
    """The CUDA entry points refuse CPU tensors at N_k != N_q too; they
    never fall back to the plain versions."""
    q, g = torch.zeros(1, 2, 17, 64), torch.zeros(1, 2, 17, 64)
    k = v = torch.zeros(1, 2, 4, 64)
    stats = torch.zeros((1, 2, 17))
    ab = torch.zeros(1, 2, 17, 4)
    with pytest.raises(ValueError, match='CUDA'):
        cuda_flash_attention(q, k, v, 0.125, ab)
    with pytest.raises(ValueError, match='CUDA'):
        cuda_flash_attention_bwd_dkv(q, k, v, g, stats, stats, 0.125, ab)
    with pytest.raises(ValueError, match='CUDA'):
        cuda_flash_attention_bwd_dq(q, k, v, g, stats, stats, 0.125, ab)


def test_microbench_needs_a_card(monkeypatch):
    """Without a card the microbench raises unless asked for the CPU, and
    on the CPU it times the plain version only, never as ``flash``."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        attn_microbench_torch.main([])
    rows = attn_microbench_torch.bench_rows(batch=(1,), seq=(9,), heads=2,
                                            head_dim=32, reps=1,
                                            device='cpu')
    assert [r['mode'] for r in rows] == ['fwd', 'fwd+bwd']
    assert all('flash' not in r and 'naive_ms' in r for r in rows)


@functools.lru_cache(maxsize=None)
def _bf16_case():
    """The plain versions in bf16 and in fp32 on the same bf16 values,
    with phase 3c's allowances and limits."""
    shape = (1, 2, 40, 16)
    scale = shape[-1]**-0.5
    q, k, v, g = [t.to(torch.bfloat16) for t in _t(*_qkvg(shape, 5))]
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    ref, ref_lse = torch_attention(qf, kf, vf, scale, return_lse=True)
    refs = (ref, *torch_attention_backward(qf, kf, vf, ref, ref_lse, gf,
                                           scale))
    o, lse = torch_attention(q, k, v, scale, return_lse=True)
    got = (o, *torch_attention_backward(q, k, v, o, lse, g, scale))
    allow = chip_smoke.flash_allowances(qf, kf, vf, gf, ref, ref_lse, scale)
    limits = (chip_smoke.FLASH_FWD_TOL * max(1.0, float(ref.abs().max())),
              *[chip_smoke.FLASH_BWD_TOL
                * max(1.0, max(float(r.abs().max()) for r in refs[1:]))] * 3)
    return got, refs, allow, limits


def test_bf16_allowances_hold_the_plain_bf16_versions():
    """O, dQ, dK, dV of the plain versions in bf16 lie within phase 3c's
    allowances of the fp32 plain versions; without the propagated part
    the forward's and dK's would not."""
    got, refs, allow, limits = _bf16_case()
    for name, x, r, a, lim in zip(('o', 'dq', 'dk', 'dv'), got, refs,
                                  allow, limits):
        assert x.dtype == torch.bfloat16
        assert chip_smoke.flash_excess(x, r, 2.0**-8, a) <= lim, name
    for i in (0, 2):
        assert chip_smoke.flash_excess(got[i], refs[i], 2.0**-8, 0.0) > \
            limits[i]


@pytest.mark.parametrize('which', ['o', 'dq', 'dk', 'dv', 'nan'])
def test_bf16_allowances_catch_an_injected_error(which):
    """Twice an element's whole allowance (rounding, propagated part and
    limit), added where the propagated part is largest, is caught; so is
    a NaN, which Python's ``max`` over floats would skip."""
    got, refs, allow, limits = _bf16_case()
    i = 'o dq dk dv'.split().index(which) if which != 'nan' else 2
    x, r, a = got[i].float().clone(), refs[i], allow[i]
    j = int(a.argmax())
    slack = 2.0**-8 * r.abs() + a + limits[i]
    flat = x.view(-1)
    if which == 'nan':
        flat[j] = float('nan')
    else:
        flat[j] += torch.sign(flat[j] - r.view(-1)[j]) * 2 * slack.view(-1)[j]
    assert chip_smoke.flash_excess(x, r, 2.0**-8, a) > limits[i]


def _library_backward(q, k, v, o, do, sm_scale):
    """The backward formulas of the TPU kernels that the flash library
    runs (``flash_attention.py``: dK/dV ``:844-921``, dQ ``:1187-1261``,
    Di ``:273-275``), for one block holding every row, in jnp with their
    roundings: P and the scaled dS are rounded to the input type before
    the products; fp32 results, before the final cast."""
    f32 = jnp.float32
    logits = jnp.einsum('...qd,...kd->...qk', q, k,
                        preferred_element_type=f32) * sm_scale
    m = logits.max(-1, keepdims=True)
    l = jnp.exp(logits - m).sum(-1, keepdims=True)
    p = jnp.exp(logits - m) * (1 / l)
    di = jnp.sum(o.astype(f32) * do.astype(f32), -1, keepdims=True)
    dv = jnp.einsum('...qk,...qd->...kd', p.astype(do.dtype), do,
                    preferred_element_type=f32)
    dp = jnp.einsum('...qd,...kd->...qk', do, v, preferred_element_type=f32)
    ds = (dp - di) * p
    ds = ds * sm_scale
    dk = jnp.einsum('...qk,...qd->...kd', ds.astype(do.dtype), q,
                    preferred_element_type=f32)
    dq = jnp.einsum('...qk,...kd->...qd', ds.astype(k.dtype), k,
                    preferred_element_type=f32)
    return dq, dk, dv


@pytest.mark.parametrize('d', [32, 64])
def test_bf16_backward_rounds_where_the_tpu_kernels_do(d):
    """The plain bf16 backward against a transcription of the library
    kernels' formulas on the same bf16 values: both round P and dS * s
    (scaled first) to bf16, so after the final cast to bf16 they agree,
    but for rare elements (at most 1 %, each within one bf16 step, 2^-7
    |ref|) that fp32 sums in another order, or P = exp(S - lse) against
    exp(S - m) / l, move across a rounding boundary. Rounding dS before
    the scale (or not at all for dQ) changes some 40 % of dQ, and of dK
    where s = d^-1/2 is no power of two (d = 32)."""
    shape = (1, 2, 40, d)
    scale = d**-0.5
    q, k, v, g = [t.to(torch.bfloat16) for t in _t(*_qkvg(shape, 6))]
    o, lse = torch_attention(q, k, v, scale, return_lse=True)
    got = torch_attention_backward(q, k, v, o, lse, g, scale)
    bf = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
          for t in (q, k, v, o, g)]
    refs = _library_backward(*bf, scale)
    for name, x, r in zip(('dq', 'dk', 'dv'), got, refs):
        assert x.dtype == torch.bfloat16
        r = torch.from_numpy(np.array(r))
        x = x.float()
        differ = x != r.to(torch.bfloat16).float()
        assert float(differ.float().mean()) <= 0.01, name
        assert bool(((x - r).abs() <= 2.0**-7 * r.abs()).all()), name


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('d', [32, 64])
def test_kernels_read_vit_qkv_views_without_a_copy(dtype, d):
    """The ViT block's q, k, v, strided views of its (B, N, 3, H, d)
    projection, meet the kernels' 16-byte rule as they are."""
    b, n, h = 2, 9, 3
    qkv = torch.zeros(b, n, 3 * h * d, dtype=dtype)
    for t in qkv.reshape(b, n, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0):
        assert _aligned(t) is t


def test_kernels_get_a_copy_of_an_unaligned_view():
    """An offset base, or a row stride that is no multiple of 16 bytes, is
    copied to a contiguous tensor with the same values; a size-1
    dimension's stride does not matter."""
    flat = torch.arange(2 * 3 * 5 * 32 + 1, dtype=torch.float32)
    offset = flat[1:].view(2, 3, 5, 32)
    wide = torch.zeros(2, 3, 5, 34)[..., :32]
    single = flat[:32 * 5].view(1, 1, 5, 32).as_strided(
        (1, 1, 5, 32), (7, 3, 32, 1))
    for t in (offset, wide):
        got = _aligned(t)
        assert got.data_ptr() != t.data_ptr() and got.is_contiguous()
        assert got.data_ptr() % 16 == 0
        torch.testing.assert_close(got, t, rtol=0, atol=0)
    assert _aligned(single) is single


def _tf32_round(x):
    """x rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it (to nearest,
    ties away from zero), on the int32 view: what ``Mma<float>::split``
    and the fp32 dQ kernel's split warps take as hi, and as lo."""
    u = x.view(torch.int32)
    finite = (u & 0x7f800000) != 0x7f800000
    return torch.where(finite, (u + 0x1000) & -0x2000, u).view(torch.float32)


def _tf32_read(x):
    """x as the tensor cores read a 32-bit TF32 input: its top 19 bits."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def _tf32_product(a, b, three):
    """a @ b as the fp32 dQ kernel takes each product: lo hi + hi lo +
    hi hi over hi = tf32(x), lo = tf32(x - hi), fp32 sums (3xTF32); or
    one TF32 product of the raw values (1xTF32, the planted control)."""
    if not three:
        return _tf32_read(a) @ _tf32_read(b)
    ah, bh = _tf32_round(a), _tf32_round(b)
    al, bl = _tf32_round(a - ah), _tf32_round(b - bh)
    return (_tf32_read(al) @ _tf32_read(bh) + _tf32_read(ah) @ _tf32_read(bl)
            + ah @ bh)


@pytest.mark.parametrize('three', [True, False],
                         ids=['3xtf32', '1xtf32-control'])
def test_fp32_dq_kernel_arithmetic_is_fp32_accurate(three):
    """The fp32 dQ kernel's arithmetic at the ViT's (1, 2, 1025, 64): S =
    Q K^T, dP = dO V^T and dQ = (dS s) K through its 3xTF32 products, dS s
    from them in fp32, within phase 3c's ``FLASH_BWD_TOL * max(1,
    max|ref|)`` of fp64; one TF32 product each (lo taken as zero) must
    break that bound, for S and for dQ."""
    q, k, v, g = _t(*_qkvg((1, 2, 1025, 64), seed=3))
    s = 64**-0.5
    qd, kd, vd, gd = (t.double() for t in (q, k, v, g))
    s_ref = qd @ kd.transpose(-1, -2)
    lse = torch.logsumexp(s_ref * s, -1, keepdim=True)
    p_ref = torch.exp(s_ref * s - lse)
    di = ((p_ref @ vd) * gd).sum(-1, keepdim=True)
    dq_ref = p_ref * (gd @ vd.transpose(-1, -2) - di) * s @ kd
    sc = _tf32_product(q, k.transpose(-1, -2), three)
    dp = _tf32_product(g, v.transpose(-1, -2), three)
    ds = torch.exp(sc * s - lse.float()) * (dp - di.float()) * s
    dq = _tf32_product(ds, k, three)
    for got, ref in ((sc, s_ref), (dq, dq_ref)):
        err = float((got.double() - ref).abs().max())
        limit = chip_smoke.FLASH_BWD_TOL * max(1.0, float(ref.abs().max()))
        assert (err <= limit) == three, (err, limit)


def _to_fp32_toward_zero(x):
    """fp64 ``x`` rounded to fp32 toward zero, as the tensor cores' fp32
    accumulate rounds an mma's sum."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f.astype(np.float64)


@pytest.mark.parametrize('flush', [256, None], ids=['flush-256', 'control'])
def test_fp32_dkv_sums_over_long_query_loops_stay_fp32_accurate(flush):
    """dV = P^T dO over MiT-B0 stage 0's 16384 queries for one block's 64
    keys, as the fp32 dK/dV kernel sums it: m16n8k8 products, three a
    k-step (3xTF32), each mma's sum rounded toward zero into its
    accumulator. Flushing the accumulators every ``kFlushRows`` = 256
    queries into rounded fp32 sums, as the kernel does, stays within phase
    3c's ``FLASH_BWD_TOL * max(1, max|ref|)`` of fp64; one accumulator
    over all 16384 (the planted control) does not."""
    rs = np.random.RandomState(9)
    nq, nk, d = 16384, 64, 32
    s = rs.randn(nq, nk)
    p = np.exp(s - s.max(1, keepdims=True))
    p /= p.sum(1, keepdims=True) * 4.0      # a row's share of 256 keys
    g = rs.randn(nq, d)
    ref = p.T @ g
    acc, total = np.zeros((nk, d)), np.zeros((nk, d), np.float32)
    for i0 in range(0, nq, 8):
        part = p[i0:i0 + 8].T @ g[i0:i0 + 8] / 3.0
        for _ in range(3):
            acc = _to_fp32_toward_zero(acc + part)
        if flush and (i0 + 8) % flush == 0:
            total += acc.astype(np.float32)
            acc = np.zeros((nk, d))
    got = total.astype(np.float64) + acc
    err = float(np.abs(got - ref).max())
    limit = chip_smoke.FLASH_BWD_TOL * max(1.0, float(np.abs(ref).max()))
    assert (err <= limit) == bool(flush), (err, limit)
