"""The global batch of the GSPMD modes: ZeRO (``zero.py``) and tensor
parallelism (``tp.py``).

The JAX files lay one program out over a mesh: each computes the
single-device step over the global batch (``zero.py:17-30``,
``tp.py:16-24``). That differs from the data-parallel step of
``mesh.py`` in three ways, and the port follows GSPMD here:

* every batch norm in train mode normalizes by the statistics of the
  whole batch, whatever its config type (``BN`` or ``SyncBN``);
* the step's random numbers are those of the single-process step over
  the global batch (one generator, ``step_generator(seed, it)``);
* the log vars, and ``grad_mag``, are those of the whole batch.

``GlobalBatch`` is passed to an algorithm's ``make_train_step`` as its
``group``. The step then runs the single-process code on the global batch,
every rank the same, and only the segmentors' forwards split it: their
entry points (``forward``, ``encode_decode``, ``extract_feat``, wrapped by
``split_forwards``) take this rank's rows of their input, run with every
batch norm reducing its statistics over the data group and every dropout
and drop-path mask drawn for the global batch (``batch_rows``), and
all-gather their outputs. What comes after, the losses, pseudo-labels and
ClassMix, runs on the gathered tensors, so it is the single-process
step's by construction. The gather's backward hands each rank its rows'
gradient times the data group's size, so that the mean over the group of
the parameters' gradients (``average_gradients``) is the whole batch's
gradient, for parameters used inside the split forward and outside it
alike. The running statistics and the log vars come out the same on
every rank and are not averaged.
"""
from __future__ import annotations

import contextlib
from typing import Iterable, List, Optional

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from . import comm
from .sync_bn import SyncBatchNorm

# the segmentor methods that take an image batch first
SPLIT_ENTRIES = ('forward', 'encode_decode', 'extract_feat')


class GlobalBatch:
    """The layout of a GSPMD step: the ``data`` group its batch is split
    over, and with tensor parallelism the ``model`` group of this rank's
    shards. ``world`` is the whole mode's group, for the one reduction of
    the gradients' norm."""

    def __init__(self, data_group=None, model_group=None, world=None):
        self.group = data_group
        self.model_group = model_group
        self.world = world
        self.n_data = dist.get_world_size(data_group) \
            if data_group is not None else 1
        self.index = dist.get_rank(data_group) \
            if data_group is not None else 0
        self.model_index = dist.get_rank(model_group) \
            if model_group is not None else 0
        self.depth = 0
        self.zero = None

    # -- the split forwards ------------------------------------------------
    @property
    def bn_group(self):
        """The group batch norms reduce over: the data group inside a
        split forward, none elsewhere."""
        return self.group if self.depth > 0 and self.n_data > 1 else None

    def rows(self, total: int) -> slice:
        """This rank's rows of a global batch of ``total``."""
        if total % self.n_data:
            raise ValueError(f'a batch of {total} does not split over '
                             f'{self.n_data} data ranks')
        n = total // self.n_data
        return slice(self.index * n, (self.index + 1) * n)

    # -- what the step calls in place of the data-parallel helpers ---------
    def average_gradients(self, params: Iterable[nn.Parameter]) -> None:
        """The whole batch's gradient: the mean over the data group of the
        gradients (ZeRO's shards by reduce-scatter, ``zero.py``)."""
        params = list(params)
        if self.zero is not None:
            self.zero.reduce_gradients(params)
            return
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.n_data > 1:
            from .mesh import _mean_in_place
            with torch.no_grad():
                _mean_in_place([p.grad for p in params], self.group)

    def grad_norm(self, params: Iterable[nn.Parameter]) -> torch.Tensor:
        """The L2 norm of the whole gradient of ``params`` (after
        ``average_gradients``), their shards summed over the groups."""
        params = list(params)
        return torch.sqrt(global_sum_sq(params, self,
                                        [_held_grad(p) for p in params]))


def is_global_batch(group) -> bool:
    return isinstance(group, GlobalBatch)


_ACTIVE: List[Optional[GlobalBatch]] = [None]


@contextlib.contextmanager
def global_batch(gb: Optional[GlobalBatch]):
    """``gb`` is the layout of the step running (``sync_bn_group`` opens
    it for a ``GlobalBatch``)."""
    prev = _ACTIVE[0]
    _ACTIVE[0] = gb
    try:
        yield
    finally:
        _ACTIVE[0] = prev


def batch_rows(batch: int):
    """(the global batch, this rank's rows) of a local batch of ``batch``
    inside a split forward; ``(batch, slice(None))`` elsewhere. A random
    draw per sample takes ``total`` and keeps ``rows``."""
    gb = _ACTIVE[0]
    if gb is None or gb.depth == 0 or gb.n_data == 1:
        return batch, slice(None)
    total = batch * gb.n_data
    return total, gb.rows(total)


class Dropout(nn.Dropout):
    """``nn.Dropout`` whose mask, inside a split forward, is drawn for the
    global batch and cut to this rank's rows (the single-process step's
    mask); elsewhere ``nn.Dropout``."""

    def forward(self, x):
        total, rows = batch_rows(x.shape[0])
        if not self.training or self.p == 0.0 or rows == slice(None):
            return super().forward(x)
        mask = F.dropout(_ones_laid_out_as(x, total), self.p, True, False)
        return x * mask[rows]


def _ones_laid_out_as(x: torch.Tensor, total: int) -> torch.Tensor:
    """Ones of ``x``'s shape with ``total`` rows, in ``x``'s memory order
    (dropout draws its mask in memory order: a channels-last map's differs
    from a contiguous one's)."""
    order = sorted(range(x.ndim), key=lambda d: (-x.stride(d), d))
    shape = [total if d == 0 else x.shape[d] for d in order]
    ones = x.new_ones(shape)
    return ones.permute([order.index(d) for d in range(x.ndim)])


class _GatherRows(torch.autograd.Function):
    """All-gather along the batch; the backward keeps this rank's rows of
    the gradient, times the data group's size."""

    @staticmethod
    def forward(ctx, x, gb):
        ctx.gb = gb
        ctx.rows = slice(gb.index * x.shape[0], (gb.index + 1) * x.shape[0])
        return comm.all_gather(x, gb.group)

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.rows] * ctx.gb.n_data, None


def _gather_tree(out, gb: GlobalBatch, batch: int):
    if isinstance(out, torch.Tensor):
        if out.ndim == 0 or out.shape[0] != batch:
            raise ValueError(f'a split forward returned a tensor of shape '
                             f'{tuple(out.shape)}, not a batch of {batch}')
        return _GatherRows.apply(out, gb)
    if isinstance(out, dict):
        return {k: _gather_tree(v, gb, batch) for k, v in out.items()}
    if isinstance(out, (list, tuple)):
        return type(out)(_gather_tree(v, gb, batch) for v in out)
    return out


def _split_entry(name):
    def call(self, img, *args, **kwargs):
        fn = getattr(super(type(self), self), name)
        gb = _ACTIVE[0]
        if gb is None or gb.depth > 0:
            return fn(img, *args, **kwargs)
        rows = gb.rows(img.shape[0])
        gb.depth += 1
        try:
            out = fn(img[rows], *args, **kwargs)
        finally:
            gb.depth -= 1
        if gb.n_data == 1:
            return out
        return _gather_tree(out, gb, rows.stop - rows.start)

    call.__name__ = name
    return call


_SPLIT_CLASSES = {}


def _split_class(cls):
    if getattr(cls, 'splits_batch', False):
        return cls
    if cls not in _SPLIT_CLASSES:
        entries = {n: _split_entry(n) for n in SPLIT_ENTRIES
                   if hasattr(cls, n)}
        _SPLIT_CLASSES[cls] = type(cls.__name__, (cls,),
                                   dict(entries, splits_batch=True,
                                        __module__=cls.__module__))
    return _SPLIT_CLASSES[cls]


def split_forwards(module: nn.Module) -> nn.Module:
    """Make ``module`` (a segmentor) a GSPMD one, in place: its entry
    points split the global batch while a ``GlobalBatch`` step runs (a
    subclass of its class, so copies keep them), its plain batch norms
    become ``SyncBatchNorm`` (the same layer outside a split forward) and
    its dropouts ``Dropout``. Idempotent."""
    module.__class__ = _split_class(type(module))
    for m in module.modules():
        if type(m) is nn.BatchNorm2d:
            m.__class__ = SyncBatchNorm
        elif type(m) is nn.Dropout:
            m.__class__ = Dropout
    return module


# -- the gradients' norm over shards ----------------------------------------
def _held_grad(p: nn.Parameter):
    """The gradient this rank holds of ``p``: its ZeRO shard's, or its
    own."""
    shard = getattr(p, 'zero_shard', None)
    return (shard if shard is not None else p).grad


def _counts_here(p, gb: GlobalBatch) -> bool:
    """Whether this rank adds ``p``'s gradient into a norm over the mode's
    group: a shard always, a leaf replicated over a group on that group's
    first rank only."""
    zero_sharded = getattr(p, 'zero_dim', None) is not None
    tp_sharded = getattr(p, 'tp_dim', None) is not None
    return (zero_sharded or gb.index == 0) and \
        (tp_sharded or gb.model_index == 0)


def global_sum_sq(params: List[nn.Parameter], gb: GlobalBatch,
                  grads: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """The sum of squares, in fp32, of the whole gradient whose parts this
    rank holds: ``grads`` (by default those of ``params``), each part of
    the parameter beside it, summed over the mode's group with one
    ``all_reduce``."""
    if grads is None:
        grads = [p.grad for p in params]
    dev = grads[0].device if grads else torch.device('cpu')
    local = torch.zeros((), device=dev, dtype=torch.float32)
    for p, g in zip(params, grads):
        if g is not None and _counts_here(p, gb):
            local = local + torch.linalg.vector_norm(g.float())**2
    if gb.world is not None and dist.get_world_size(gb.world) > 1:
        dist.all_reduce(local, group=gb.world)
    return local


def global_flag(flag: torch.Tensor, gb: GlobalBatch) -> torch.Tensor:
    """``flag`` (0-dim, 1.0 or 0.0) raised on any rank of the mode's
    group."""
    flag = flag.float().reshape(1)
    if gb.world is not None and dist.get_world_size(gb.world) > 1:
        dist.all_reduce(flag, group=gb.world)
    return flag[0] > 0
