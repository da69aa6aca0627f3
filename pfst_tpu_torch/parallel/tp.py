"""Megatron tensor parallelism over a ``(data, model)`` layout of the ranks
(port of ``pfst_tpu/parallel/tp.py``).

The JAX file lays the transformer blocks' weights out over a ``model``
mesh axis and leaves the function to GSPMD: ``qkv``/``q``/``k``/``v`` and
``fc1`` kernels column-sharded, ``proj`` and ``fc2`` row-sharded
(``DEFAULT_TP_RULES``), the batch over ``data``, one program computing the
single-device step. Here the function is what is ported:

* the attention's stacked ``in_proj_weight`` (3C, C) keeps, on model rank
  m of n, the rows of its heads (H/n of them) in each of q, k and v, and
  the flash kernels run on those heads, (B, H/n, N, d), through
  ``ops.attention``; ``out_proj`` keeps the matching C/n input columns;
* the MLP's ``fc1`` keeps hidden/n output rows, ``fc2`` the matching
  input columns;
* before each column-parallel product the input passes ``_CopyToModel``
  (identity forward, ``all_reduce`` of the gradient over the model group
  backward), and after each row-parallel one ``_ReduceFromModel`` (its
  conjugate); the row-parallel bias is added once, after the reduction.

Sharded: the attention of ``backbones/vit.py`` (ViT's) and the ``FFN`` of
ViT, BEiT, MAE and Swin. A config whose blocks hold another attention
(BEiT's and MAE's, Swin's, MiT's, Twins') or MiT's ``MixFFN`` raises
(ROADMAP A14c). Leaves
the rules match outside those blocks (ResNeSt's and the fast CNNs'
``fc1``/``fc2``, Twins' patch-embed ``proj``) are held whole on every
model rank; ``tree_specs`` names them all the same, as the JAX function
does. Every other module runs replicated on the model ranks, on the same
samples (the loader shards by data index), so their leaves stay equal on
the model ranks without a collective.

The step is the GSPMD one of ``global_batch.py`` (the whole batch's BN
statistics, random numbers, log vars): ``make_tp_train_step`` runs the
algorithm's step with a ``GlobalBatch`` over the data group. Every
gradient is averaged over the data group; the optimizer's clip and
non-finite check read the global norm (``ScheduledOptimizer.layout``).
Checkpoints are whole: ``whole_state_dict`` gathers the shards.
"""
from __future__ import annotations

import functools
import re
from collections import namedtuple
from typing import Dict, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from ..core.convert import key_families
from . import comm

DATA_AXIS = 'data'
MODEL_AXIS = 'model'

# (JAX path-suffix regex, spec over the JAX leaf's dimensions), first
# match wins, unmatched leaves replicated (``tp.py:41-45``)
DEFAULT_TP_RULES: Tuple[Tuple[str, tuple], ...] = (
    (r'/(qkv|q|k|v|fc1)/kernel$', (None, MODEL_AXIS)),
    (r'/(qkv|q|k|v|fc1)/bias$', (MODEL_AXIS,)),
    (r'/(proj|fc2)/kernel$', (MODEL_AXIS, None)),
)

Layout2D = namedtuple('Layout2D', 'data model world n_data n_model '
                      'data_index model_index')


def get_2d_groups(n_model: int, group=None) -> Layout2D:
    """The ``(data, model)`` layout of the ranks of ``group`` (the default
    group): rank r is data index ``r // n_model`` and model index
    ``r % n_model`` (the JAX ``reshape(n // n_model, n_model)``). Every
    rank of ``group`` must call it, in the same order as the others."""
    group = group if group is not None else dist.group.WORLD
    ranks = comm.group_ranks(group)
    n = len(ranks)
    if n % n_model:
        raise AssertionError(f'{n} devices not divisible by tp={n_model}')
    me = dist.get_rank(group)
    data = model = None
    for m in range(n_model):
        g = dist.new_group([ranks[d * n_model + m]
                            for d in range(n // n_model)])
        if me % n_model == m:
            data = g
    for d in range(n // n_model):
        g = dist.new_group(ranks[d * n_model:(d + 1) * n_model])
        if me // n_model == d:
            model = g
    return Layout2D(data, model, group, n // n_model, n_model,
                    me // n_model, me % n_model)


def _spec_for(path: str, ndim: int, rules) -> tuple:
    if ndim == 0:
        return ()
    for pattern, spec in rules:
        if re.search(pattern, path):
            return spec if len(spec) <= ndim else ()
    return ()


def jax_paths(module: nn.Module) -> Dict[str, str]:
    """Each parameter's JAX path, ``/``-led (``core.optimizers.
    param_paths``)."""
    from ..core.optimizers import param_paths
    return {k: '/' + v for k, v in param_paths(
        module.named_parameters(), **key_families(module)).items()}


def tree_specs(module: nn.Module, rules=DEFAULT_TP_RULES) -> Dict[str, tuple]:
    """``{JAX path: spec}`` of ``module``'s parameters by the rules (a
    spec over the JAX leaf's dimensions, ``()`` replicated); the same
    leaves the JAX ``tree_specs`` names."""
    paths = jax_paths(module)
    return {paths[n]: _spec_for(paths[n], p.ndim, rules)
            for n, p in module.named_parameters()}


# -- the two conjugate collectives -------------------------------------------
class _CopyToModel(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        return _reduce(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        return _reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group``, in fp32, back in ``x``'s type."""
    y = x.float().contiguous()
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


# -- the sharded blocks ------------------------------------------------------
@functools.lru_cache(None)
def _tp_attention_cls():
    from ..models.backbones.vit import MultiheadAttention
    from ..ops import attention

    class TPMultiheadAttention(MultiheadAttention):
        """``vit.MultiheadAttention`` holding this model rank's heads."""

        def forward(self, x):
            b, n, c = x.shape
            heads = self.tp_heads
            hd = c // self.num_heads
            x = _CopyToModel.apply(x, self.tp_group)
            qkv = F.linear(x, self.attn.in_proj_weight,
                           self.attn.in_proj_bias)
            q, k, v = qkv.reshape(b, n, 3, heads, hd).permute(
                2, 0, 3, 1, 4).unbind(0)
            o = attention(q, k, v, hd**-0.5)
            out = self.attn.out_proj
            y = F.linear(o.transpose(1, 2).reshape(b, n, heads * hd),
                         out.weight)
            return _ReduceFromModel.apply(y, self.tp_group) + out.bias

    return TPMultiheadAttention


@functools.lru_cache(None)
def _tp_ffn_cls():
    from ..models.backbones.vit import FFN

    class TPFFN(FFN):
        """``vit.FFN`` holding this model rank's hidden units."""

        def forward(self, x):
            fc1, act = self.layers[0]
            fc2 = self.layers[1]
            x = _CopyToModel.apply(x, self.tp_group)
            h = act(fc1(x))
            y = F.linear(h, fc2.weight)
            return _ReduceFromModel.apply(y, self.tp_group) + fc2.bias

    return TPFFN


# the attention classes whose blocks are not sharded yet
_WAITING = ('BEiTAttention', 'WindowMSA', 'EfficientAttention', 'MixFFN',
            'LocalAttention')


def _set_shard(p: nn.Parameter, shard: torch.Tensor, dim: int, kind: str):
    """``p`` becomes ``shard`` in place (the optimizer's references stay),
    its state in an optimizer cut the same way by ``shard_optimizer``."""
    p.data = shard.contiguous().clone()
    p.tp_dim = dim
    p.tp_kind = kind


def _q_k_v_rows(total: int, m: int, n: int) -> torch.Tensor:
    c = total // 3
    per = c // n
    return torch.cat([torch.arange(j * c + m * per, j * c + (m + 1) * per)
                      for j in range(3)])


def _cut(t: torch.Tensor, kind: str, dim: int, m: int, n: int):
    if kind == 'qkv':
        return t.index_select(0, _q_k_v_rows(t.shape[0], m, n).to(t.device))
    size = t.shape[dim] // n
    return t.narrow(dim, m * size, size)


def shard_model(module: nn.Module, layout: Layout2D) -> nn.Module:
    """Tensor-parallel surgery on ``module`` in place: each ViT attention
    keeps its model rank's heads, each FFN its hidden units (module
    docstring). Raises for an attention that waits."""
    att_cls, ffn_cls = _tp_attention_cls(), _tp_ffn_cls()
    n, m = layout.n_model, layout.model_index
    for name, mod in module.named_modules():
        kind = type(mod).__name__
        if kind in _WAITING:
            raise NotImplementedError(
                f'tensor parallelism of {kind} ({name}) is not ported '
                f'(ROADMAP A14c): the ViT attention and the FFN are')
        if type(mod) is att_cls.__mro__[1]:
            if mod.num_heads % n:
                raise ValueError(f'{mod.num_heads} heads do not split over '
                                 f'tp={n}')
            ip = mod.attn
            for p, kind_, dim in ((ip.in_proj_weight, 'qkv', 0),
                                  (ip.in_proj_bias, 'qkv', 0),
                                  (ip.out_proj.weight, 'cols', 1)):
                _set_shard(p, _cut(p.data, kind_, dim, m, n), dim, kind_)
            mod.__class__ = att_cls
            mod.tp_heads = mod.num_heads // n
            mod.tp_group = layout.model
        elif type(mod) is ffn_cls.__mro__[1]:
            fc1, fc2 = mod.layers[0][0], mod.layers[1]
            if fc1.out_features % n:
                raise ValueError(f'{fc1.out_features} hidden units do not '
                                 f'split over tp={n}')
            for p, kind_, dim in ((fc1.weight, 'rows', 0),
                                  (fc1.bias, 'rows', 0),
                                  (fc2.weight, 'cols', 1)):
                _set_shard(p, _cut(p.data, kind_, dim, m, n), dim, kind_)
            mod.__class__ = ffn_cls
            mod.tp_group = layout.model
    return module


def _whole(t: torch.Tensor, kind: str, dim: int, group) -> torch.Tensor:
    """The whole tensor of this rank's shard ``t``."""
    n = dist.get_world_size(group)
    if kind == 'qkv':
        parts = comm.all_gather(t, group, 0).reshape(n, 3, -1,
                                                     *t.shape[1:])
        return parts.transpose(0, 1).reshape(-1, *t.shape[1:])
    return comm.all_gather(t, group, dim)


def whole_tensors(module: nn.Module, tensors: Dict[str, torch.Tensor],
                  group) -> Dict[str, torch.Tensor]:
    """``tensors`` (by ``module``'s parameter names, shaped as its shards)
    made whole over the model ``group``; collective."""
    params = dict(module.named_parameters())
    out = {}
    for k, t in tensors.items():
        p = params.get(k)
        dim = getattr(p, 'tp_dim', None) if p is not None else None
        out[k] = t if dim is None else _whole(t, p.tp_kind, dim, group)
    return out


def cut_like(p: nn.Parameter, t: torch.Tensor, layout: Layout2D):
    """A whole tensor ``t`` of ``p``'s shape cut as ``p`` is."""
    dim = getattr(p, 'tp_dim', None)
    if dim is None:
        return t
    return _cut(t, p.tp_kind, dim, layout.model_index, layout.n_model)


def make_tp_train_step(algo, mean, std, sharding,
                       collect_vis: bool = False):
    """The dp x tp step, ``(state, batch, generator) -> (state,
    log_vars)``: ``batch`` this data index's rows (the same on its model
    ranks), ``generator`` the single-process step's
    (``step_generator(seed, it)``). It all-gathers the batch over the data
    group and runs ``algo``'s step on it as a ``GlobalBatch`` step.
    ``sharding`` is the state's (``shard_state``, or ``zero.shard_state``
    with a 2-D layout)."""
    from .zero import make_global_step
    return make_global_step(algo, mean, std, sharding, collect_vis)


def shard_state(state, layout: Layout2D):
    """Tensor-parallel surgery on the state's segmentors (student, teacher,
    frozen reference) and on the optimizer's moments, in place; the
    segmentors split the global batch (``split_forwards``). The state
    must be whole and the same on every rank (a resumed one included)."""
    from .zero import attach
    return attach(state, layout, level=0)


def cut_optimizer(opt, layout: Layout2D) -> None:
    """The optimizer's moments and accumulator of the sharded parameters,
    whole from a resume, cut as the parameters are."""
    for i, p in enumerate(opt.params):
        st = opt.optimizer.state.get(p) or {}
        for k, v in list(st.items()):
            if isinstance(v, torch.Tensor) and v.ndim and \
                    v.shape != p.shape:
                st[k] = cut_like(p, v, layout)
        if opt.acc is not None and opt.acc[i].shape != p.shape:
            opt.acc[i] = cut_like(p, opt.acc[i], layout)
