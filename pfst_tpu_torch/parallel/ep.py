"""Expert parallelism: a top-1 mixture of experts over an ``expert``
group (port of ``pfst_tpu/parallel/ep.py``).

A Switch-style top-1-routed MoE FFN with expert ``e`` on rank ``e``:
each rank routes its own tokens, buckets them by expert with the cumsum
dispatch and position-ordered capacity truncation (``top1_dispatch``),
exchanges the buckets with ``all_to_all_single`` so that every rank runs
only its expert on what it received, exchanges the results back, and
combines them scaled by the gate probability. Tokens over capacity come
out as zeros (Switch semantics); with enough capacity the layer is the
dense per-token computation. The exchange's backward is the same
``all_to_all`` of the gradient (``_AllToAll``), its transpose.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from . import comm
from .pp import stack_stage_params  # noqa: F401 - shared with pp

EXPERT_AXIS = 'expert'


def get_expert_group(n_experts: Optional[int] = None, group=None):
    """The group of the first ``n_experts`` ranks of ``group`` (the
    default group), every rank when None (``ep.py:25-34``); every rank of
    ``group`` must call it."""
    group = group if group is not None else dist.group.WORLD
    ranks = comm.group_ranks(group)
    if n_experts is not None:
        if n_experts > len(ranks):
            raise ValueError(
                f'{n_experts} experts need {n_experts} devices, only '
                f'{len(ranks)} available')
        ranks = ranks[:n_experts]
    return dist.new_group(ranks)


def top1_dispatch(gate_logits: torch.Tensor, capacity: int):
    """(T, E) logits -> (the gate probability of each token's expert (T,),
    the dispatch one-hot (T, E, capacity)): a token's slot is its position
    among the tokens routed to its expert, and slots past ``capacity`` are
    dropped (``ep.py:41-54``)."""
    e = gate_logits.shape[1]
    probs = torch.softmax(gate_logits, dim=-1)
    idx = probs.argmax(dim=-1)
    gate = probs.gather(1, idx[:, None])[:, 0]
    onehot = F.one_hot(idx, e).to(gate_logits.dtype)           # (T, E)
    pos = (torch.cumsum(onehot, dim=0) - 1.0) * onehot          # (T, E)
    keep = (pos < capacity).to(onehot.dtype) * onehot
    slot = pos.sum(-1).long()
    pos_oh = F.one_hot(slot.clamp(max=capacity - 1), capacity).to(
        onehot.dtype) * (slot < capacity).to(onehot.dtype)[:, None]
    return gate, keep[:, :, None] * pos_oh[:, None, :]


class _AllToAll(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return comm.all_to_all(x, group)

    @staticmethod
    def backward(ctx, grad):
        return comm.all_to_all(grad, ctx.group), None


def moe_apply(expert_fn: Callable, stacked_params: Dict[str, torch.Tensor],
              x: torch.Tensor, gate_w: torch.Tensor, group,
              capacity_factor: float = 2.0) -> torch.Tensor:
    """The MoE layer on this rank's tokens ``x`` (T_local, D): rank e
    runs ``expert_fn(params_e, tokens) -> tokens`` with slice e of
    ``stacked_params`` ((E, ...) leaves); ``gate_w`` (D, E) the same on
    every rank (``ep.py:57-102``). Returns this rank's (T_local, D)
    outputs."""
    n_exp = dist.get_world_size(group)
    names = list(stacked_params)
    n_stacked = stacked_params[names[0]].shape[0]
    if n_stacked != n_exp:
        raise ValueError(
            f'{n_stacked} stacked experts on a {n_exp}-device expert '
            'group - one expert per device required')
    if gate_w.shape[-1] != n_exp:
        raise ValueError(
            f'gate_w routes to {gate_w.shape[-1]} experts but the '
            f'group has {n_exp}')
    t_local = x.shape[0]
    capacity = max(1, int(capacity_factor * t_local / n_exp))
    me = dist.get_rank(group)
    params = {k: v[me] for k, v in stacked_params.items()}
    gate, disp = top1_dispatch(x @ gate_w, capacity)
    send = torch.einsum('tec,td->ecd', disp, x)        # (E, Cap, D)
    recv = _AllToAll.apply(send, group)                 # dim 0: the source
    out = expert_fn(params, recv.reshape(n_exp * capacity, x.shape[-1]))
    back = _AllToAll.apply(out.reshape(n_exp, capacity, -1), group)
    return torch.einsum('ecd,tec->td', back, disp) * gate[:, None]
