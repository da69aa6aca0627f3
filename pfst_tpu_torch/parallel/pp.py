"""GPipe pipeline parallelism over a ``pipe`` group (port of
``pfst_tpu/parallel/pp.py``).

A stack of blocks that keep their activation's shape (the transformer
blocks of ViT, BEiT, MiT: (B, N, C) -> (B, N, C)) runs with stage ``i``
on rank ``i`` of the group: the batch is cut into ``m`` microbatches,
stage 0 takes them in order, each stage sends its output to the next
with a point-to-point send, and the schedule takes ``m + P - 1`` time
steps for ``P`` stages (stage ``d`` works on microbatch ``t - d`` at step
``t``, as the JAX ``scan`` does). The last stage's outputs are broadcast
to every rank, the JAX ``psum`` of zeros. The backward runs the schedule
in reverse (``_GPipe``, an autograd function): each stage takes its
output's gradient from the next stage, backpropagates through its saved
microbatch graph and sends the input's gradient to the previous stage
(the JAX file gets it by transposing ``ppermute``). The loss is read as
one function computed alike on every rank from the replicated output
(the JAX replicated ``out_specs``): the backward starts from the last
stage's own output gradient, and the input's gradient is stage 0's,
broadcast. Stage ``d`` gets the gradient of its slice ``d`` of the
stacked parameters, zeros elsewhere (the JAX sharded gradient).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist
import torch.nn as nn

from . import comm

PIPE_AXIS = 'pipe'


def get_pipe_group(n_stages: Optional[int] = None, group=None):
    """The group of the first ``n_stages`` ranks of ``group`` (the
    default group), every rank when None (``pp.py:29-38``). Every rank of
    ``group`` must call it; a rank outside the pipe gets a non-member."""
    group = group if group is not None else dist.group.WORLD
    ranks = comm.group_ranks(group)
    if n_stages is not None:
        if n_stages > len(ranks):
            raise ValueError(
                f'{n_stages} pipeline stages need {n_stages} devices, '
                f'only {len(ranks)} available')
        ranks = ranks[:n_stages]
    return dist.new_group(ranks)


def stack_stage_params(params_list: List[Dict[str, torch.Tensor]]):
    """``[stage0_tree, stage1_tree, ...]`` -> one tree stacked on dim 0
    (``pp.py:41-44``); rank i reads slice i."""
    return {k: torch.stack([p[k] for p in params_list])
            for k in params_list[0]}


def module_block_fn(block: nn.Module) -> Callable:
    """``block_fn(params, act)`` running ``block`` with ``params`` (a
    ``{name: tensor}`` tree of its parameters) in place of its own."""
    def block_fn(params, act):
        return torch.func.functional_call(block, params, (act,))
    return block_fn


class _GPipe(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, block_fn, group, m, names, *leaves):
        n_dev = dist.get_world_size(group)
        d = dist.get_rank(group)
        mb = x.shape[0] // m
        params = {k: leaf[d].detach().requires_grad_(leaf.requires_grad)
                  for k, leaf in zip(names, leaves)}
        inputs, outputs = [], []
        buf = x.new_empty((mb,) + tuple(x.shape[1:]))
        for j in range(m):
            if d == 0:
                inp = x[j * mb:(j + 1) * mb].detach()
            else:
                inp = comm.send_recv(None, None, buf.clone(), d - 1, group)
            inp.requires_grad_(x.requires_grad or d > 0)
            with torch.enable_grad():
                out = block_fn(params, inp)
            if d < n_dev - 1:
                comm.send_recv(out.detach(), d + 1, None, None, group)
            inputs.append(inp)
            outputs.append(out)
        if d == n_dev - 1:
            result = torch.cat([o.detach() for o in outputs])
        else:
            result = torch.empty_like(x)
        dist.broadcast(result, dist.get_global_rank(group, n_dev - 1),
                       group=group)
        ctx.state = (params, inputs, outputs, group, d, n_dev, m, mb)
        ctx.names = names
        ctx.x_grad = x.requires_grad
        return result

    @staticmethod
    def backward(ctx, grad):
        params, inputs, outputs, group, d, n_dev, m, mb = ctx.state
        names = ctx.names
        plist = [params[k] for k in names]
        wants = [p for p in plist if p.requires_grad]
        pgrads = [torch.zeros_like(p) for p in plist]
        dx = grad.new_zeros(grad.shape) if ctx.x_grad else None
        for j in reversed(range(m)):
            if d == n_dev - 1:
                g = grad[j * mb:(j + 1) * mb].contiguous()
            else:
                g = comm.send_recv(None, None,
                                   torch.empty_like(outputs[j]), d + 1,
                                   group)
            inp = inputs[j]
            targets = ([inp] if inp.requires_grad else []) + wants
            got = torch.autograd.grad(outputs[j], targets, g,
                                      allow_unused=True)
            gin = got[0] if inp.requires_grad else None
            it = iter(got[1:] if inp.requires_grad else got)
            for i, p in enumerate(plist):
                if p.requires_grad:
                    gp = next(it)
                    if gp is not None:
                        pgrads[i] += gp
            if d > 0:
                comm.send_recv(gin, d - 1, None, None, group)
            elif dx is not None:
                dx[j * mb:(j + 1) * mb] = gin
        if dx is not None:
            dist.broadcast(dx, dist.get_global_rank(group, 0), group=group)
        stacked = []
        for g_p, p in zip(pgrads, plist):
            full = g_p.new_zeros((n_dev,) + tuple(g_p.shape))
            full[d] = g_p
            stacked.append(full)
        ctx.state = None
        return (dx, None, None, None, None, *stacked)


def gpipe_apply(block_fn: Callable, stacked_params: Dict[str, torch.Tensor],
                x: torch.Tensor, group, n_microbatches: int) -> torch.Tensor:
    """``block_{P-1}(... block_0(x))`` with stage i on rank i of ``group``
    (``pp.py:54-111``). ``block_fn(stage_params, act) -> act`` of the same
    shape; ``stacked_params`` a tree of (P, ...) tensors (every rank reads
    its slice); ``x`` (B, ...), the same on every rank, B divisible by
    ``n_microbatches``. The result is replicated on every rank and
    differentiable end to end."""
    n_dev = dist.get_world_size(group)
    names = list(stacked_params)
    n_stages = stacked_params[names[0]].shape[0]
    if n_stages != n_dev:
        raise ValueError(
            f'{n_stages} stacked stages on a {n_dev}-device pipe group '
            '- each device must hold exactly one stage (a silent '
            'mismatch would drop stages)')
    m = n_microbatches
    assert x.shape[0] % m == 0, (tuple(x.shape), m)
    return _GPipe.apply(x, block_fn, group, m, names,
                        *[stacked_params[k] for k in names])
