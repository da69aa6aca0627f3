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
from jax.experimental.pallas.ops.tpu.flash_attention import \
    mha_reference  # noqa: E402

from pfst_tpu_torch.ops import (attention, cuda_flash_attention,  # noqa: E402
                                cuda_flash_attention_bwd_dkv,
                                cuda_flash_attention_bwd_dq, torch_attention,
                                torch_attention_backward)

sys.path.insert(0, osp.join(osp.dirname(__file__), '..', 'tools'))
import attn_microbench  # noqa: E402
import attn_microbench_torch  # noqa: E402

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
