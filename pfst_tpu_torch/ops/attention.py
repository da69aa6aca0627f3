"""Scaled dot-product attention with an optional additive bias,
``softmax((q k^T + ab) * scale) v`` (port of the Pallas TPU flash
attention that ``tools/attn_microbench.py::flash`` calls,
``jax.experimental.pallas.ops.tpu.flash_attention`` in jax 0.9.0, whose
``ab`` argument (``flash_attention.py:144``) this is, added to the logits
before the scale (``:399-409``); and of the attention of the ViT, BEiT
and Swin blocks, ``pfst_tpu/models/backbones/{vit,beit,swin}.py``).

q, k, v are ``(B, H, N, D)``; ``ab`` is fp32 ``(B, H, N, N)`` or ``(1, H,
N, N)`` (one bias for every batch, read with a batch stride of 0), or
None; non-causal, no segment ids. A module whose bias is added after the
scale (BEiT's and Swin's relative-position tables) passes ``bias /
scale``.

* ``torch_attention``: the plain version, the naive formula of
  ``attn_microbench.py:22-27``: fp32 scores and softmax, P rounded to v's
  type before ``P V`` (accumulated in fp32), output in q's type. With
  ``return_lse`` it also gives the fp32 log-sum-exp of each query row.
* ``torch_attention_backward``: the plain FlashAttention-2 backward in
  fp32 from the forward's ``o`` and ``lse``: ``P = exp(S - lse)``,
  ``Di = rowsum(dO o)``, ``dS = P (dO V^T - Di)``, ``dQ = (dS s) K``,
  ``dK = (dS s)^T Q``, ``dV = P^T dO`` and, with ``ab``, ``dab = dS s``
  in fp32 (the library's dQ kernel writes it, ``:1243-1253``), with P
  and ``dS s`` rounded to the inputs' type before the products, where the
  backward kernels round them: the TPU kernels scale dS before they round
  it (``ds * sm_scale``, then ``ds.astype``).
* ``cuda_flash_attention``: the forward kernel (``csrc/flash_attention.cu``)
  -> ``(o, lse)``; ``cuda_flash_attention_bwd_dkv`` and
  ``cuda_flash_attention_bwd_dq`` (which also writes ``dab``): the two
  backward kernels, each with its own ``launches`` count;
  ``cuda_flash_attention_backward`` runs both.
* ``attention``: a CUDA tensor goes through an autograd Function whose
  forward and backward are the kernels (``ab``'s gradient is dab, summed
  over the batch for a ``(1, H, N, N)`` bias); a CPU tensor goes to the
  plain version under ordinary autograd. There is no switch between them.

The three kernels run on the tensor cores: bf16 input as bf16 products
with fp32 sums, rounding P (forward), P^T and dS^T s (dK/dV) and dS s (dQ)
to bf16 where the TPU kernels round them (``p.astype(v.dtype)``,
``p.T.astype``, ``ds.T.astype``, ``ds.astype``); fp32 input as 3xTF32,
accurate to fp32. dQ in both types and the bf16 forward and dK/dV are
warpgroup (``wgmma``) kernels fed by TMA (fp32 dQ as TF32 ``wgmma`` on
hi and lo parts that the kernel splits in shared memory); the fp32
forward and dK/dV are warp (``mma.sync``) kernels fed by ``cp.async``.
Both copy data in 16-byte units, so each q, k, v, dO they
read has a 16-byte-aligned base and batch, head and row strides that are
multiples of 16 bytes; ``_aligned`` copies a tensor that breaks this (the
ViT's qkv views never do). ``ab`` is read with scalar loads through
its own strides and needs only a contiguous last dimension.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

HEAD_DIMS = (32, 64, 128)


def _scores(q, k, scale, ab):
    """fp32 ``(q k^T + ab) * scale``; ``q k^T * scale`` without ``ab``."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    return s * scale if ab is None else (s + ab.float()) * scale


def torch_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, return_lse: bool = False,
                    ab: Optional[torch.Tensor] = None):
    """Plain version: (B, H, N, D) -> (B, H, N, D) in q's type (and the
    (B, H, N) fp32 log-sum-exp with ``return_lse``)."""
    s = _scores(q, k, scale, ab)
    p = torch.softmax(s, dim=-1)
    o = torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)
    if return_lse:
        return o, torch.logsumexp(s, dim=-1)
    return o


def torch_attention_backward(q, k, v, o, lse, grad, scale, ab=None):
    """Plain version of the backward kernels: ``(dq, dk, dv)`` in the
    inputs' types for ``o = attention(q, k, v, ab=ab)`` with its ``lse``
    and ``grad = dL/do``, computed in fp32; for bf16 input P and the
    scaled dS are rounded to bf16 before the dV, dK and dQ products, as in
    the kernels and the TPU kernels. With ``ab`` also ``dab = dS s``, fp32
    (B, H, N, N), taken before that rounding."""
    qf, kf, vf, gf = q.float(), k.float(), v.float(), grad.float()
    p = torch.exp(_scores(qf, kf, scale, ab) - lse.float()[..., None])
    di = (o.float() * gf).sum(dim=-1, keepdim=True)
    dab = p * (torch.matmul(gf, vf.transpose(-1, -2)) - di) * scale
    ds = dab.to(q.dtype).float()
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    dv = torch.matmul(p.to(q.dtype).float().transpose(-1, -2), gf)
    out = dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
    return out if ab is None else (*out, dab)


def _check_args(q, k, v, ab=None):
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f'expected q, k, v of one (B, H, N, D) shape, got '
                         f'{tuple(q.shape)}, {tuple(k.shape)}, '
                         f'{tuple(v.shape)}')
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f'q, k, v differ in type: {q.dtype}, {k.dtype}, '
                        f'{v.dtype}')
    if ab is not None:
        b, h, n, _ = q.shape
        if ab.ndim != 4 or ab.shape[0] not in (1, b) or \
                tuple(ab.shape[1:]) != (h, n, n):
            raise ValueError(f'ab must be ({b} or 1, {h}, {n}, {n}) for q '
                             f'of {tuple(q.shape)}, got {tuple(ab.shape)}')


def _check_kernel_input(q, k, v):
    _check_args(q, k, v)
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'the kernels take float32 or bfloat16, got '
                        f'{q.dtype}')
    b, h, n, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f'the kernels take a head dimension in '
                         f'{HEAD_DIMS}, got {d}')
    if n == 0 or not 1 <= b <= 65535 or not 1 <= h <= 65535:
        raise ValueError(f'the kernels take 1 to 65535 batches and heads '
                         f'and a non-empty sequence, got {tuple(q.shape)}')
    for t in (q, k, v):
        if t.device.type != 'cuda' or t.device != q.device:
            raise ValueError(f'the kernels take CUDA tensors on one device, '
                             f'got {q.device}, {k.device}, {v.device}')


def _bias(ab, q):
    """``ab`` as the kernels read it (fp32 on q's device, a contiguous last
    dimension: else a contiguous copy), or None."""
    if ab is None:
        return None
    _check_args(q, q, q, ab)
    if ab.dtype != torch.float32 or ab.device != q.device:
        raise TypeError(f'the kernels take a float32 ab on {q.device}, got '
                        f'{ab.dtype} on {ab.device}')
    return ab if ab.stride(-1) == 1 else ab.contiguous()


def _aligned(t):
    """``t`` if the kernels can read it through its strides: a contiguous
    last dimension, a 16-byte-aligned base, and batch, head and row strides
    that are multiples of 16 bytes (the strides of size-1 dimensions are
    never used); else a contiguous copy."""
    step = 16 // t.element_size()
    if t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and all(
            st % step == 0 for n, st in zip(t.shape[:3], t.stride()[:3])
            if n > 1):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _strides(*tensors):
    vals = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _bias_strides(ab, dab=None):
    """The (batch, head, row) strides of ``ab`` and ``dab`` (zeros for an
    absent one); a batch of 1 is read with batch stride 0."""
    vals = [0] * 6
    for i, t in enumerate((ab, dab)):
        if t is not None:
            vals[3 * i:3 * i + 3] = [0 if t.shape[0] == 1 else t.stride(0),
                                     t.stride(1), t.stride(2)]
    return (ctypes.c_longlong * 6)(*vals)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _library():
    from .build import load
    lib = load('flash_attention')
    if lib.pfst_flash_attention_forward.argtypes is None:
        i, p, f = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
        lib.pfst_flash_attention_forward.argtypes = \
            [p] * 6 + [i] * 4 + [p, p, f, i, i, p]
        lib.pfst_flash_attention_bwd_dkv.argtypes = \
            [p] * 9 + [i] * 4 + [p, p, f, i, i, p]
        lib.pfst_flash_attention_bwd_dq.argtypes = \
            [p] * 9 + [i] * 4 + [p, p, f, i, i, p]
        for fn in (lib.pfst_flash_attention_forward,
                   lib.pfst_flash_attention_bwd_dkv,
                   lib.pfst_flash_attention_bwd_dq):
            fn.restype = i
        lib.pfst_flash_error_string.argtypes = [i]
        lib.pfst_flash_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, err, what):
    if err != 0:
        raise RuntimeError(f'{what} kernel launch failed: '
                           + lib.pfst_flash_error_string(err).decode())


def _device_and_stream(t):
    """The launch's device index and PyTorch's current stream there."""
    return t.device.index, torch.cuda.current_stream(t.device).cuda_stream


def _launch_forward(lib, q, k, v, scale, ab):
    """Allocate and launch; no checks. O is laid out (B, N, H, D) and
    returned as its (B, H, N, D) view, so ``o.transpose(1, 2).reshape(B,
    N, H * D)`` is free."""
    b, h, n, d = q.shape
    o = torch.empty((b, n, h, d), dtype=q.dtype,
                    device=q.device).transpose(1, 2)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    err = lib.pfst_flash_attention_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), _ptr(ab), b, h, n, d, _strides(q, k, v, o),
        _bias_strides(ab), float(scale), int(q.dtype == torch.bfloat16),
        *_device_and_stream(q))
    _raise_on(lib, err, 'flash_attention forward')
    return o, lse


def _launch_bwd_dkv(lib, q, k, v, grad, lse, di, scale, ab):
    b, h, n, d = q.shape
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    err = lib.pfst_flash_attention_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), grad.data_ptr(),
        lse.data_ptr(), di.data_ptr(), _ptr(ab), dk.data_ptr(),
        dv.data_ptr(), b, h, n, d, _strides(q, k, v, grad, dk, dv),
        _bias_strides(ab), float(scale), int(q.dtype == torch.bfloat16),
        *_device_and_stream(q))
    _raise_on(lib, err, 'flash_attention dK/dV')
    return dk, dv


def _launch_bwd_dq(lib, q, k, v, grad, lse, di, scale, ab):
    b, h, n, d = q.shape
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dab = None if ab is None else torch.empty(
        (b, h, n, n), dtype=torch.float32, device=q.device)
    err = lib.pfst_flash_attention_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), grad.data_ptr(),
        lse.data_ptr(), di.data_ptr(), _ptr(ab), dq.data_ptr(), _ptr(dab),
        b, h, n, d, _strides(q, k, v, grad, dq), _bias_strides(ab, dab),
        float(scale), int(q.dtype == torch.bfloat16),
        *_device_and_stream(q))
    _raise_on(lib, err, 'flash_attention dQ')
    return dq, dab


def cuda_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float, ab: Optional[torch.Tensor] = None):
    """The forward kernel: ``(o, lse)``, o (B, H, N, D) in q's type (a view
    of a (B, N, H, D) tensor), lse (B, H, N) fp32, launched on the current
    stream; ``ab`` the fp32 bias added before the scale, or None.
    ``launches`` counts launches."""
    _check_kernel_input(q, k, v)
    out = _launch_forward(_library(), _aligned(q), _aligned(k), _aligned(v),
                          scale, _bias(ab, q))
    cuda_flash_attention.launches += 1
    return out


cuda_flash_attention.launches = 0


def _check_stats(name, t, shape, device):
    if tuple(t.shape) != shape or t.dtype != torch.float32 or \
            t.device != device or not t.is_contiguous():
        raise ValueError(f'{name} must be a contiguous float32 {shape} '
                         f'tensor on {device}, got {t.dtype} '
                         f'{tuple(t.shape)} on {t.device}')


def _check_backward_input(q, k, v, grad, lse, di):
    _check_kernel_input(q, k, v)
    if grad.shape != q.shape or grad.dtype != q.dtype or \
            grad.device != q.device:
        raise ValueError(f'grad must match q: got {grad.dtype} '
                         f'{tuple(grad.shape)} on {grad.device}')
    for name, t in (('lse', lse), ('di', di)):
        _check_stats(name, t, tuple(q.shape[:3]), q.device)


def cuda_flash_attention_bwd_dkv(q, k, v, grad, lse, di, scale, ab=None):
    """The dK/dV kernel: ``(dk, dv)`` from q, k, v, ``grad`` = dL/do, the
    forward's ``lse`` and ``di = rowsum(grad * o)`` (B, H, N) fp32, and
    the forward's ``ab``. One launch on the current stream; ``launches``
    counts launches."""
    _check_backward_input(q, k, v, grad, lse, di)
    out = _launch_bwd_dkv(_library(), _aligned(q), _aligned(k), _aligned(v),
                          _aligned(grad), lse, di, scale, _bias(ab, q))
    cuda_flash_attention_bwd_dkv.launches += 1
    return out


cuda_flash_attention_bwd_dkv.launches = 0


def cuda_flash_attention_bwd_dq(q, k, v, grad, lse, di, scale, ab=None):
    """The dQ kernel (``wgmma`` + TMA, bf16 or fp32 as 3xTF32): ``dq``
    from the same inputs as the dK/dV kernel, and with ``ab`` ``(dq,
    dab)``, ``dab = dS s`` fp32 (B, H, N, N), as
    ``torch_attention_backward`` returns it. ``launches`` counts
    launches."""
    _check_backward_input(q, k, v, grad, lse, di)
    dq, dab = _launch_bwd_dq(_library(), _aligned(q), _aligned(k),
                             _aligned(v), _aligned(grad), lse, di, scale,
                             _bias(ab, q))
    cuda_flash_attention_bwd_dq.launches += 1
    return dq if ab is None else (dq, dab)


cuda_flash_attention_bwd_dq.launches = 0


def cuda_flash_attention_backward(q, k, v, o, lse, grad, scale, ab=None):
    """``(dq, dk, dv)``, and with ``ab`` also ``dab`` (B, H, N, N) fp32,
    through the two backward kernels; ``di = rowsum(grad * o)`` is a
    PyTorch reduction, as the library computes it in XLA outside its
    kernels (``flash_attention.py:273-275``)."""
    di = (o.float() * grad.float()).sum(dim=-1).contiguous()
    dk, dv = cuda_flash_attention_bwd_dkv(q, k, v, grad, lse, di, scale, ab)
    dq = cuda_flash_attention_bwd_dq(q, k, v, grad, lse, di, scale, ab)
    return (dq, dk, dv) if ab is None else (dq[0], dk, dv, dq[1])


class _FlashAttention(torch.autograd.Function):
    """The forward kernel, with the two backward kernels as its gradient;
    ``ab``'s gradient is dab, summed over the batch where one bias served
    every batch."""

    @staticmethod
    def forward(ctx, q, k, v, ab, scale):
        o, lse = cuda_flash_attention(q, k, v, scale, ab)
        ctx.save_for_backward(q, k, v, o, lse, ab)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, grad):
        q, k, v, o, lse, ab = ctx.saved_tensors
        grads = cuda_flash_attention_backward(q, k, v, o, lse, grad,
                                              ctx.scale, ab)
        dab = None
        if ab is not None and ctx.needs_input_grad[3]:
            dab = grads[3]
            if ab.shape[0] == 1 and dab.shape[0] > 1:
                dab = dab.sum(0, keepdim=True)
        return grads[0], grads[1], grads[2], dab, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float, ab: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
    """``softmax((q k^T + ab) * scale) v``, dispatched on where q lies: the
    kernels on the card (forward, and backward when a gradient is taken),
    the plain version under ordinary autograd on the CPU."""
    if q.device.type == 'cuda':
        return _FlashAttention.apply(q, k, v, ab, float(scale))
    if q.device.type != 'cpu':
        raise ValueError(f'no attention for {q.device}')
    _check_args(q, k, v, ab)
    return torch_attention(q, k, v, scale, ab=ab)
