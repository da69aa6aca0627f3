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
  (``csrc/neighborhood_sim.cu``), built at first use.
* ``neighborhood_similarity``: a CUDA tensor goes to the kernel, a CPU
  tensor to the plain version; there is no switch between them.

Forward only; the backward comes with the training path.
"""
from __future__ import annotations

import ctypes

import torch

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
    fn = lib.pfst_neighborhood_sim
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + \
            [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.pfst_cuda_error_string.argtypes = [ctypes.c_int]
        lib.pfst_cuda_error_string.restype = ctypes.c_char_p
    return lib


def cuda_neighborhood_similarity(x: torch.Tensor, kernel_size: int,
                                 dilation: int, sim_type: str = 'cosine',
                                 sigma: float = 30.0) -> torch.Tensor:
    """The kernel: (B, C, H, W) fp32/bf16 on the card -> (B, k*k, H, W)
    fp32, launched on the current stream. ``launches`` counts launches."""
    _check_args(x, kernel_size, dilation, sim_type)
    if x.device.type != 'cuda':
        raise ValueError(f'the kernel takes a CUDA tensor, got {x.device}')
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'the kernel takes float32 or bfloat16, got '
                        f'{x.dtype}')
    if not x.is_contiguous():
        raise ValueError('the kernel takes a contiguous NCHW tensor')
    b, c, h, w = x.shape
    if x.numel() == 0 or b > 65535:
        raise ValueError(f'the kernel takes 1 to 65535 non-empty images, '
                         f'got {tuple(x.shape)}')
    lib = _library()
    out = torch.empty((b, kernel_size**2, h, w), device=x.device,
                      dtype=torch.float32)
    err = lib.pfst_neighborhood_sim(
        x.data_ptr(), out.data_ptr(), b, c, h, w, kernel_size, dilation,
        int(sim_type == 'cosine'), float(sigma),
        int(x.dtype == torch.bfloat16), x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError('neighborhood_sim kernel launch failed: '
                           + lib.pfst_cuda_error_string(err).decode())
    cuda_neighborhood_similarity.launches += 1
    return out


cuda_neighborhood_similarity.launches = 0


def neighborhood_similarity(x: torch.Tensor, kernel_size: int,
                            dilation: int, sim_type: str = 'cosine',
                            sigma: float = 30.0) -> torch.Tensor:
    """Dispatch on where ``x`` lies: the kernel on the card, the plain
    version on the CPU."""
    if x.device.type == 'cuda':
        return cuda_neighborhood_similarity(x.contiguous(), kernel_size,
                                            dilation, sim_type, sigma)
    if x.device.type != 'cpu':
        raise ValueError(f'no neighborhood_similarity for {x.device}')
    _check_args(x, kernel_size, dilation, sim_type)
    return torch_neighborhood_similarity(x, kernel_size, dilation,
                                         sim_type, sigma)
