"""Parity of the port's ops (``pfst_tpu_torch.ops``) with the JAX ones.

Same numpy-seeded inputs go through the JAX function (NHWC) and the
port's (NCHW, on the CPU, where the similarity runs its plain version).
Tolerances: resize 1e-5 (fp32 interpolation, same grid); unfold and its
mask exact (pure data movement); similarity 1e-5 (fp32 sums over C in
another order).
"""
import numpy as np
import pytest
import torch

# torch's OpenMP pool must not run beside XLA-CPU in one process
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from pfst_tpu.ops.pallas_sim import xla_neighborhood_similarity  # noqa: E402
from pfst_tpu.ops.resize import adaptive_avg_pool_1x1 as jax_pool  # noqa: E402
from pfst_tpu.ops.resize import resize as jax_resize  # noqa: E402
from pfst_tpu.ops.unfold import unfold_neighbors as jax_unfold  # noqa: E402
from pfst_tpu.ops.unfold import unfold_valid_mask as jax_mask  # noqa: E402
from pfst_tpu_torch import ops  # noqa: E402
from pfst_tpu_torch.ops import build  # noqa: E402


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize('mode,align_corners', [
    ('bilinear', False), ('bilinear', True), ('nearest', None)])
@pytest.mark.parametrize('size,scale_factor', [
    ((29, 40), None), ((7, 9), None), (None, 2.0), (None, 0.5),
    ((1, 1), None)])
def test_resize_matches_jax(mode, align_corners, size, scale_factor):
    x = np.random.RandomState(0).randn(2, 13, 17, 3).astype(np.float32)
    ref = np.asarray(jax_resize(
        jnp.asarray(x), size=size, scale_factor=scale_factor, mode=mode,
        align_corners=align_corners))
    out = ops.resize(_nchw(x), size=size, scale_factor=scale_factor,
                     mode=mode, align_corners=align_corners)
    assert _nhwc(out).shape == ref.shape
    np.testing.assert_allclose(_nhwc(out), ref, atol=1e-5, rtol=0)


def test_resize_chw_and_identity():
    x = np.random.RandomState(1).randn(1, 6, 5, 4).astype(np.float32)
    t = _nchw(x)
    assert ops.resize(t, size=(6, 5)) is t
    out = ops.resize(t[0], size=(12, 10), mode='bilinear')
    ref = np.asarray(jax_resize(jnp.asarray(x[0]), size=(12, 10)))
    np.testing.assert_allclose(out.numpy().transpose(1, 2, 0), ref,
                               atol=1e-5, rtol=0)
    with pytest.raises(ValueError):
        ops.resize(t, size=(3, 3), mode='bicubic')
    with pytest.raises(ValueError):
        ops.resize(t)


def test_adaptive_avg_pool_matches_jax():
    x = np.random.RandomState(2).randn(2, 9, 7, 5).astype(np.float32)
    ref = np.asarray(jax_pool(jnp.asarray(x)))
    out = ops.adaptive_avg_pool_1x1(_nchw(x))
    np.testing.assert_allclose(_nhwc(out), ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize('k,d', [(3, 1), (3, 2), (5, 1), (5, 2)])
def test_unfold_neighbors_exact(k, d):
    x = np.random.RandomState(3).randn(2, 9, 11, 4).astype(np.float32)
    ref = np.asarray(jax_unfold(jnp.asarray(x), k, d))
    out = ops.unfold_neighbors(_nchw(x), k, d)          # (B, k2, C, H, W)
    np.testing.assert_array_equal(out.numpy().transpose(0, 3, 4, 1, 2), ref)
    assert torch.equal(out[:, k * k // 2], _nchw(x))


@pytest.mark.parametrize('k,d', [(3, 1), (3, 2), (5, 1), (5, 2)])
def test_unfold_valid_mask_exact(k, d):
    ref = np.asarray(jax_mask(9, 11, k, d))
    out = ops.unfold_valid_mask(9, 11, k, d)            # (k2, H, W)
    np.testing.assert_array_equal(out.numpy().transpose(1, 2, 0), ref)


def test_unfold_rejects_even_kernel():
    with pytest.raises(ValueError):
        ops.unfold_neighbors(torch.zeros(1, 2, 5, 5), 4, 1)


@pytest.mark.parametrize('sim_type', ['cosine', 'gaussian'])
@pytest.mark.parametrize('k,d', [(3, 1), (3, 2), (5, 1), (5, 2)])
def test_plain_similarity_matches_xla(k, d, sim_type):
    rs = np.random.RandomState(4)
    x = (rs.randn(2, 10, 12, 16) * 0.7).astype(np.float32)
    x[0, 3, 4] = 0.0   # a zero feature exercises the cosine eps clamp
    ref = np.asarray(xla_neighborhood_similarity(
        jnp.asarray(x), k, d, sim_type=sim_type, sigma=4.0))
    out = ops.torch_neighborhood_similarity(_nchw(x), k, d,
                                            sim_type=sim_type, sigma=4.0)
    assert out.dtype == torch.float32
    assert out.shape == (2, k * k, 10, 12)
    np.testing.assert_allclose(_nhwc(out), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize('sim_type', ['cosine', 'gaussian'])
def test_dispatch_on_cpu_runs_plain_version(sim_type):
    x = torch.from_numpy(
        np.random.RandomState(5).randn(1, 32, 8, 8).astype(np.float32))
    launches = ops.cuda_neighborhood_similarity.launches
    out = ops.neighborhood_similarity(x, 3, 2, sim_type=sim_type,
                                      sigma=30.0)
    ref = ops.torch_neighborhood_similarity(x, 3, 2, sim_type=sim_type,
                                            sigma=30.0)
    assert torch.equal(out, ref)
    # bf16 features are widened to fp32, as the kernel does
    out16 = ops.neighborhood_similarity(x.bfloat16(), 3, 2,
                                        sim_type=sim_type, sigma=30.0)
    ref16 = ops.torch_neighborhood_similarity(x.bfloat16().float(), 3, 2,
                                              sim_type=sim_type, sigma=30.0)
    assert out16.dtype == torch.float32 and torch.equal(out16, ref16)
    assert ops.cuda_neighborhood_similarity.launches == launches


@pytest.mark.parametrize('kwargs', [
    dict(kernel_size=4, dilation=1, sim_type='cosine'),
    dict(kernel_size=9, dilation=1, sim_type='cosine'),
    dict(kernel_size=3, dilation=0, sim_type='cosine'),
    dict(kernel_size=3, dilation=1, sim_type='l2')])
def test_similarity_rejects_bad_arguments(kwargs):
    with pytest.raises(ValueError):
        ops.neighborhood_similarity(torch.zeros(1, 4, 6, 6), **kwargs)


def test_kernel_wrapper_refuses_cpu_tensors():
    # the kernel never runs on the CPU, and nothing launches
    launches = ops.cuda_neighborhood_similarity.launches
    with pytest.raises(ValueError, match='CUDA tensor'):
        ops.cuda_neighborhood_similarity(torch.zeros(1, 4, 6, 6), 3, 2)
    assert ops.cuda_neighborhood_similarity.launches == launches


def test_kernel_library_path_is_keyed_by_source():
    path = build.library_path('neighborhood_sim')
    assert path.startswith(build.BUILD_DIR)
    assert path == build.library_path('neighborhood_sim')
    name = path.rsplit('/', 1)[1]
    assert name.startswith('neighborhood_sim_') and name.endswith('.so')


def test_kernel_library_path_is_keyed_by_every_header(tmp_path, monkeypatch):
    """A source may include any ``csrc/*.cuh``: editing one, or adding
    one, gives a new library, so a stale build is never loaded."""
    (tmp_path / 'k.cu').write_text('#include "a.cuh"\n')
    (tmp_path / 'a.cuh').write_text('// v1\n')
    monkeypatch.setattr(build, 'CSRC_DIR', str(tmp_path))
    first = build.library_path('k')
    assert build.library_path('k') == first
    (tmp_path / 'a.cuh').write_text('// v2\n')
    second = build.library_path('k')
    assert second != first
    (tmp_path / 'b.cuh').write_text('// new\n')
    assert build.library_path('k') not in (first, second)
