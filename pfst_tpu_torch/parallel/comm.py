"""The collectives of the sharded modes (``zero``, ``tp``, ``pp``, ``ep``,
``spatial``), each over an explicit group.

NCCL runs every one of them on CUDA tensors. gloo runs them all on CPU
tensors, and on CUDA tensors all but the point-to-point ones (gloo ranks
that share one GPU are how the sharded modes are checked on a one-card
machine). Which
operations go through pinned host memory is decided up front, from the
group's backend and the tensor's device, never by catching an error: on
gloo, a CUDA tensor of an operation in ``STAGED_ON_GLOO`` is copied to
the host, the collective runs there, and the result is copied back. No
computation moves off the card. ``staged_operations(group, device)``
names the operations a group stages, for the caller to print.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

# gloo's operations that take CPU tensors only: on a CUDA tensor gloo's
# point-to-point send aborts the process (a TCP write of the device
# pointer); its all-gather, reduce-scatter and all-to-all take CUDA tensors
# (``tools/gloo_cuda_probe_torch.py``, torch 2.11)
STAGED_ON_GLOO = ('send', 'recv')


def staged_operations(group, device) -> tuple:
    """The operations that ``group`` stages through the host for tensors
    on ``device``."""
    if group is None or torch.device(device).type != 'cuda' or \
            dist.get_backend(group) != 'gloo':
        return ()
    return STAGED_ON_GLOO


def _staged(group, op: str, t: torch.Tensor) -> bool:
    return op in staged_operations(group, t.device)


def _host(t: torch.Tensor) -> torch.Tensor:
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return out.copy_(t)


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group`` in place."""
    dist.all_reduce(t, group=group)
    return t


class _SumOverRanks(torch.autograd.Function):
    """The sum over ``group``; every rank's gradient is the sum over the
    group of the gradients of the sum, since each rank's output feeds its
    own part of the loss."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of ``t``, out of place and differentiable
    (its backward is the same sum of the gradients)."""
    return _SumOverRanks.apply(t, group)


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' equal-shaped ``t`` concatenated along ``dim`` in rank
    order."""
    world = dist.get_world_size(group)
    src = t.movedim(dim, 0).contiguous()
    out = src.new_empty((world * src.shape[0],) + src.shape[1:])
    if _staged(group, 'all_gather', src):
        host_out = _host(out)
        dist.all_gather_into_tensor(host_out, _host(src), group=group)
        out.copy_(host_out)
    else:
        dist.all_gather_into_tensor(out, src, group=group)
    return out.movedim(0, dim)


def reduce_scatter(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The sum over ``group`` of ``t``, this rank's equal share of it
    along ``dim``."""
    world = dist.get_world_size(group)
    src = t.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // world,) + src.shape[1:])
    if _staged(group, 'reduce_scatter', src):
        host_out = _host(out)
        dist.reduce_scatter_tensor(host_out, _host(src), group=group)
        out.copy_(host_out)
    else:
        dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim)


def all_to_all(t: torch.Tensor, group,
               out_splits: Optional[Sequence[int]] = None,
               in_splits: Optional[Sequence[int]] = None) -> torch.Tensor:
    """``all_to_all_single`` along dim 0: rank r's ``in_splits[q]`` rows
    go to rank q, and the result holds ``out_splits[q]`` rows from each
    rank q in rank order (equal splits when not given). Its transpose is
    the same call with the splits swapped: ``spatial.py``'s halo exchange
    makes that its backward."""
    src = t.contiguous()
    rows = sum(out_splits) if out_splits is not None else src.shape[0]
    out = src.new_empty((rows,) + src.shape[1:])
    osplit = list(out_splits) if out_splits is not None else None
    isplit = list(in_splits) if in_splits is not None else None
    if _staged(group, 'all_to_all', src):
        host_out = _host(out)
        dist.all_to_all_single(host_out, _host(src), osplit, isplit,
                               group=group)
        out.copy_(host_out)
    else:
        dist.all_to_all_single(out, src, osplit, isplit, group=group)
    return out


def send_recv(out: Optional[torch.Tensor], dst: Optional[int],
              buf: Optional[torch.Tensor], src: Optional[int],
              group) -> Optional[torch.Tensor]:
    """Send ``out`` to the rank ``dst`` of ``group`` and receive into
    ``buf`` from the rank ``src`` (either may be None), both posted
    before either is waited on, so a ring of ranks does not deadlock."""
    ops, keep = [], []
    if out is not None:
        t = out.contiguous()
        if _staged(group, 'send', t):
            t = _host(t)
        keep.append(t)
        ops.append(dist.isend(t, dist.get_global_rank(group, dst),
                              group=group))
    host = None
    if buf is not None:
        host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True) \
            if _staged(group, 'recv', buf) else buf
        ops.append(dist.irecv(host, dist.get_global_rank(group, src),
                              group=group))
    for op in ops:
        op.wait()
    if buf is not None and host is not buf:
        buf.copy_(host)
    return buf


def group_ranks(group) -> List[int]:
    """The global ranks of ``group`` in its order."""
    return [dist.get_global_rank(group, i)
            for i in range(dist.get_world_size(group))]
