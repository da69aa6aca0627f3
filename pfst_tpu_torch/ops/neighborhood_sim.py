"""Dilated-neighborhood similarity (port of ``pfst_tpu/ops/pallas_sim.py``).

For every pixel, the cosine (or gaussian) similarity of its C-channel
feature to each of its k x k dilated neighbors, zero padded by
``(k//2)*d``, in row-major ``nn.Unfold`` order (center at ``k*k//2``).
Input ``(B, C, H, W)``, output ``(B, k*k, H, W)`` fp32.

* ``torch_neighborhood_similarity``: the plain PyTorch version, the
  shifted-slice formula of ``xla_neighborhood_similarity``
  (``pallas_sim.py:86-98``). It runs for tensors on the CPU and is what
  the kernel is held against on the card.
* ``cuda_neighborhood_similarity``: the hand-written ``sm_90a`` kernel
  (``csrc/neighborhood_sim.cu``), built at first use. A block owns a row
  segment of 32 pixels and splits the channels across its warps, each
  streaming its channels' rows and halo through shared memory by
  ``cp.async``; the warps' partial sums meet in shared memory in a fixed
  order, so the result is deterministic.
* ``torch_neighborhood_similarity_backward`` and
  ``cuda_neighborhood_similarity_backward``: ``grad_x`` from the saved
  ``sim`` and ``grad_sim``, in gather form (see below), as plain PyTorch
  and as the backward kernel of the same file, which for cosine reads the
  per-pixel norms that the forward kernel saved.
* ``neighborhood_similarity``: a CUDA tensor goes through an autograd
  Function whose forward and backward are the two kernels; a CPU tensor
  goes to the plain forward under ordinary autograd. There is no switch
  between them.

The backward in gather form. With ``n_q(p) = x(p + o_q)`` (0 outside
the map) and ``c = x(p)``, each input pixel ``p`` collects its own k*k
"center" terms ``g_q(p) ds_q(p)/dc`` and the k*k "neighbor" terms
``g_q(r) ds_q(r)/dn`` of the pixels ``r = p - o_q`` inside the map that
have ``p`` as their q-th neighbor. Since ``p - o_q = p + o_(k*k-1-q)``,
both sums read the same k*k pixels, so ``grad_x(p) = sum_j W_j x(p + o_j)
- E x(p)`` with per-pixel scalars ``W_j`` and ``E``:

* cosine, ``D = |n| |c|``: ``ds/dc = n / D - s c / |c|^2`` and
  ``ds/dn = c / D - s n / |n|^2`` where ``D > 1e-8``; where the forward
  clamps ``D`` to 1e-8 they are ``n / 1e-8`` and ``c / 1e-8``;
* gaussian: ``ds/dc = 2 s (n - c) / sigma^2 = -ds/dn``. An out-of-map
  neighbor drops its neighbor term but keeps its center term.

At a pixel whose feature vector is exactly zero the JAX VJP (through
``sqrt``) gives NaN; this form gives the finite limit.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .unfold import unfold_neighbors

_EPS = 1e-8
_KERNEL_SIZES = (3, 5, 7)
_SIM_TYPES = ('cosine', 'gaussian')


def torch_neighborhood_similarity(x: torch.Tensor, kernel_size: int,
                                  dilation: int, sim_type: str = 'cosine',
                                  sigma: float = 30.0) -> torch.Tensor:
    """Plain version: (B, C, H, W) -> (B, k*k, H, W) fp32."""
    x = x.float()
    unf = unfold_neighbors(x, kernel_size, dilation)   # (B, k*k, C, H, W)
    center = x[:, None]
    if sim_type == 'gaussian':
        d2 = ((unf - center)**2).sum(dim=2)
        return torch.exp(-d2 / sigma**2)
    num = (unf * center).sum(dim=2)
    na = torch.sqrt((unf**2).sum(dim=2))
    nb = torch.sqrt((center**2).sum(dim=2))
    return num / torch.clamp(na * nb, min=_EPS)


def _shift_back(t: torch.Tensor, kernel_size: int,
                dilation: int) -> torch.Tensor:
    """(B, k*k, H, W) -> the same with plane q read at ``p - o_q`` (zero
    where that pixel is outside the map): the value plane q holds for
    the pixel that has ``p`` as its q-th neighbor."""
    k, (h, w) = kernel_size, t.shape[2:]
    pad = (k // 2) * dilation
    tp = F.pad(t, (pad, pad, pad, pad))
    planes = []
    for q in range(k * k):
        oy, ox = (q // k - k // 2) * dilation, (q % k - k // 2) * dilation
        planes.append(tp[:, q, pad - oy:pad - oy + h, pad - ox:pad - ox + w])
    return torch.stack(planes, dim=1)


def torch_neighborhood_similarity_backward(
        x: torch.Tensor, sim: torch.Tensor, grad: torch.Tensor,
        kernel_size: int, dilation: int, sim_type: str = 'cosine',
        sigma: float = 30.0) -> torch.Tensor:
    """Plain version of the backward kernel: ``grad_x`` (in ``x.dtype``)
    for ``sim = f(x)`` (B, k*k, H, W) and ``grad`` = dL/dsim, in the
    gather form of the module docstring, accumulated in fp32."""
    k2 = kernel_size**2
    xf = x.float()
    grad = grad.float()
    sim = sim.float()
    unf = unfold_neighbors(xf, kernel_size, dilation)     # (B, k2, C, H, W)
    if sim_type == 'gaussian':
        scale = 2.0 / sigma**2
        # center terms: +a on n = x(p + o_q), -a on c = x(p)
        a = grad * sim * scale
        # neighbor terms of r = p - o_q: +g on x(r), -g on x(p)
        g = _shift_back(grad * sim, kernel_size, dilation) * scale
        coef_n, coef_c, coef_r, coef_p = a, a, g, g
    else:
        norm = torch.sqrt((xf * xf).sum(dim=1))             # (B, H, W)
        norm_n = unfold_neighbors(norm[:, None], kernel_size,
                                  dilation)[:, :, 0]        # (B, k2, H, W)
        inv_c2 = torch.where(norm > 0, 1.0 / (norm * norm), 0.0)[:, None]
        # center terms: neighbor n = x(p + o_q), center c = x(p)
        prod = norm_n * norm[:, None]
        clamped = prod <= _EPS
        coef_n = grad / torch.clamp(prod, min=_EPS)
        coef_c = torch.where(clamped, 0.0, grad * sim * inv_c2)
        # neighbor terms: center r = p - o_q, neighbor n = x(p)
        g_r = _shift_back(grad, kernel_size, dilation)
        s_r = _shift_back(sim, kernel_size, dilation)
        prod_r = norm[:, None] * norm_n.flip(1)
        clamped_r = prod_r <= _EPS
        coef_r = g_r / torch.clamp(prod_r, min=_EPS)
        coef_p = torch.where(clamped_r, 0.0, g_r * s_r * inv_c2)
    weights = coef_n + coef_r.flip(1)                       # W_j
    weights[:, k2 // 2] -= coef_c.sum(dim=1) + coef_p.sum(dim=1)   # - E
    return (weights[:, :, None] * unf).sum(dim=1).to(x.dtype)


def _check_args(x, kernel_size, dilation, sim_type):
    if x.ndim != 4:
        raise ValueError(f'expected (B, C, H, W), got {tuple(x.shape)}')
    if kernel_size not in _KERNEL_SIZES:
        raise ValueError(f'kernel_size must be one of {_KERNEL_SIZES}, '
                         f'got {kernel_size}')
    if dilation < 1:
        raise ValueError(f'dilation must be >= 1, got {dilation}')
    if sim_type not in _SIM_TYPES:
        raise ValueError(f'sim_type must be one of {_SIM_TYPES}, '
                         f'got {sim_type!r}')


def _library():
    from .build import load
    lib = load('neighborhood_sim')
    if lib.pfst_neighborhood_sim.argtypes is None:
        i, p = ctypes.c_int, ctypes.c_void_p
        lib.pfst_neighborhood_sim.argtypes = \
            [p] * 3 + [i] * 7 + [ctypes.c_float, i, i, p]
        lib.pfst_neighborhood_sim_backward.argtypes = \
            [p] * 5 + [i] * 7 + [ctypes.c_float, i, i, p]
        lib.pfst_neighborhood_sim.restype = i
        lib.pfst_neighborhood_sim_backward.restype = i
        lib.pfst_cuda_error_string.argtypes = [i]
        lib.pfst_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_kernel_input(x, kernel_size, dilation, sim_type):
    _check_args(x, kernel_size, dilation, sim_type)
    if x.device.type != 'cuda':
        raise ValueError(f'the kernel takes a CUDA tensor, got {x.device}')
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'the kernel takes float32 or bfloat16, got '
                        f'{x.dtype}')
    if not x.is_contiguous():
        raise ValueError('the kernel takes a contiguous NCHW tensor')
    if x.numel() == 0 or x.shape[0] > 65535:
        raise ValueError(f'the kernel takes 1 to 65535 non-empty images, '
                         f'got {tuple(x.shape)}')


def _check_fp32(name, t, shape, device):
    if tuple(t.shape) != shape or t.dtype != torch.float32 or \
            t.device != device or not t.is_contiguous():
        raise ValueError(f'{name} must be a contiguous float32 {shape} '
                         f'tensor on {device}, got {t.dtype} '
                         f'{tuple(t.shape)} on {t.device}')


def _raise_on(lib, err, what):
    if err != 0:
        raise RuntimeError(f'{what} kernel launch failed: '
                           + lib.pfst_cuda_error_string(err).decode())


def _device_and_stream(t):
    """The launch's device index and PyTorch's current stream there."""
    return t.device.index, torch.cuda.current_stream(t.device).cuda_stream


def cuda_neighborhood_similarity(x: torch.Tensor, kernel_size: int,
                                 dilation: int, sim_type: str = 'cosine',
                                 sigma: float = 30.0,
                                 with_norms: bool = False):
    """The kernel: (B, C, H, W) fp32/bf16 on the card -> (B, k*k, H, W)
    fp32, launched on the current stream. With ``with_norms`` (cosine
    only) it returns ``(sim, norms)``: the per-pixel feature norms
    (B, H, W) fp32, which it reduces anyway, for the backward kernel.
    ``launches`` counts launches."""
    _check_kernel_input(x, kernel_size, dilation, sim_type)
    if with_norms and sim_type != 'cosine':
        raise ValueError('only the cosine similarity saves norms')
    b, c, h, w = x.shape
    lib = _library()
    out = torch.empty((b, kernel_size**2, h, w), device=x.device,
                      dtype=torch.float32)
    norms = torch.empty((b, h, w), device=x.device, dtype=torch.float32) \
        if with_norms else None
    err = lib.pfst_neighborhood_sim(
        x.data_ptr(), out.data_ptr(),
        None if norms is None else norms.data_ptr(), b, c, h, w,
        kernel_size, dilation, int(sim_type == 'cosine'), float(sigma),
        int(x.dtype == torch.bfloat16), *_device_and_stream(x))
    _raise_on(lib, err, 'neighborhood_sim')
    cuda_neighborhood_similarity.launches += 1
    return (out, norms) if with_norms else out


cuda_neighborhood_similarity.launches = 0


def cuda_neighborhood_similarity_backward(
        x: torch.Tensor, sim: torch.Tensor, grad: torch.Tensor,
        kernel_size: int, dilation: int, sim_type: str = 'cosine',
        sigma: float = 30.0, norms: torch.Tensor = None) -> torch.Tensor:
    """The backward kernel: ``grad_x`` in ``x.dtype`` for ``sim``
    (B, k*k, H, W) fp32 and its ``grad`` fp32, on the card, accumulated in
    fp32. Cosine takes the forward's ``norms`` (B, H, W) fp32
    (``cuda_neighborhood_similarity(..., with_norms=True)``). One launch
    on the current stream; ``launches`` counts launches."""
    _check_kernel_input(x, kernel_size, dilation, sim_type)
    b, c, h, w = x.shape
    _check_fp32('sim', sim, (b, kernel_size**2, h, w), x.device)
    _check_fp32('grad', grad, (b, kernel_size**2, h, w), x.device)
    if sim_type == 'cosine':
        if norms is None:
            raise ValueError('the cosine backward takes the forward\'s norms')
        _check_fp32('norms', norms, (b, h, w), x.device)
    lib = _library()
    out = torch.empty_like(x)
    err = lib.pfst_neighborhood_sim_backward(
        x.data_ptr(), sim.data_ptr(),
        None if norms is None else norms.data_ptr(), grad.data_ptr(),
        out.data_ptr(), b, c, h, w, kernel_size, dilation,
        int(sim_type == 'cosine'), float(sigma),
        int(x.dtype == torch.bfloat16), *_device_and_stream(x))
    _raise_on(lib, err, 'neighborhood_sim backward')
    cuda_neighborhood_similarity_backward.launches += 1
    return out


cuda_neighborhood_similarity_backward.launches = 0


class _KernelSimilarity(torch.autograd.Function):
    """The forward kernel, with the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, x, kernel_size, dilation, sim_type, sigma):
        if sim_type == 'cosine':
            sim, norms = cuda_neighborhood_similarity(
                x, kernel_size, dilation, sim_type, sigma, with_norms=True)
        else:
            sim = cuda_neighborhood_similarity(x, kernel_size, dilation,
                                               sim_type, sigma)
            norms = None
        ctx.save_for_backward(x, sim, norms)
        ctx.args = (kernel_size, dilation, sim_type, sigma)
        return sim

    @staticmethod
    def backward(ctx, grad):
        x, sim, norms = ctx.saved_tensors
        grad_x = cuda_neighborhood_similarity_backward(
            x, sim, grad.float().contiguous(), *ctx.args, norms=norms)
        return grad_x, None, None, None, None


def neighborhood_similarity(x: torch.Tensor, kernel_size: int,
                            dilation: int, sim_type: str = 'cosine',
                            sigma: float = 30.0) -> torch.Tensor:
    """Dispatch on where ``x`` lies: the kernels on the card (forward,
    and backward when a gradient is taken), the plain version under
    ordinary autograd on the CPU."""
    if x.device.type == 'cuda':
        return _KernelSimilarity.apply(x.contiguous(), kernel_size,
                                       dilation, sim_type, float(sigma))
    if x.device.type != 'cpu':
        raise ValueError(f'no neighborhood_similarity for {x.device}')
    _check_args(x, kernel_size, dilation, sim_type)
    return torch_neighborhood_similarity(x, kernel_size, dilation,
                                         sim_type, sigma)
