"""ZeRO-1 and ZeRO-3 over the data group (port of
``pfst_tpu/parallel/zero.py``).

The JAX file partitions the optimizer's moments (level 1) and also the
student, teacher and frozen-reference trees (level 3) over the ``data``
mesh axis as layouts of one GSPMD program. Here each data rank is a
process: its optimizer holds a shard of each leaf, cut along the first
largest dimension that divides by the data group's size (``_zero_dim``,
the JAX rule of ``zero.py:55-69``: a tensor-parallel dimension is kept,
scalars and leaves with no such dimension stay whole). A step
reduce-scatters each sharded leaf's gradient along that dimension into
its shard (a whole leaf's gradient is all-reduced), runs AdamW on the
shards (elementwise: the same arithmetic as on the whole leaf, the same
weight decay and schedule count on every shard), and all-gathers the new
parameters. The optimizer's clip and non-finite check read the global
norm and flag (``ScheduledOptimizer.layout``).

At level 3 the state's segmentors live sharded between steps (each
parameter's tensor is empty and its shard kept beside it), and the step
gathers each whole tree before its forwards and drops it after: the
gather is per tree, not per module, so a step's peak holds the whole
student, teacher and reference, and the memory between steps is
1/n of theirs. The running statistics stay whole.

The step is the GSPMD one of ``global_batch.py``: the single-process
step over the global batch, each rank's segmentor forwards on its rows,
every batch norm over the whole batch (``make_global_step``). With a 2-D
layout (``tp.get_2d_groups``) it composes with tensor parallelism
(``tp.py``). Checkpoints are whole: every rank gathers, rank 0 writes the
unsharded state in the port's layout (``whole_state_dict``,
``whole_optimizer_entry``), so the single-process port and the converters
read it; a resume loads it whole and ``shard_state`` cuts it again.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from ..core.optimizers import ScheduledOptimizer
from . import comm
from . import tp as tp_mod
from .global_batch import GlobalBatch, split_forwards

DATA_AXIS = 'data'


def get_data_layout(group=None) -> tp_mod.Layout2D:
    """The layout of a ZeRO step without tensor parallelism: every rank of
    ``group`` (the default group) a data index."""
    group = group if group is not None else dist.group.WORLD
    return tp_mod.Layout2D(group, None, group, dist.get_world_size(group),
                           1, dist.get_rank(group), 0)


def _zero_dim(shape, n_data: int, tp_dim: Optional[int] = None):
    """The dimension a leaf of ``shape`` is sharded along over ``n_data``
    ranks: the first largest one, other than ``tp_dim``, that divides by
    ``n_data``; None for a scalar, one data rank, or no such dimension."""
    if len(shape) == 0 or n_data <= 1:
        return None
    free = [(shape[d], -d) for d in range(len(shape))
            if d != tp_dim and shape[d] >= n_data and shape[d] % n_data == 0]
    return -max(free)[1] if free else None


def state_segmentors(state) -> List[nn.Module]:
    """The segmentors of a train state: student, teacher, frozen
    reference (those that are set)."""
    return [m for m in (getattr(state, k, None)
                        for k in ('student', 'teacher', 'imnet'))
            if isinstance(m, nn.Module)]


_TREES = (('params', 'student'), ('ema_params', 'teacher'),
          ('imnet_params', 'imnet'))


def zero_specs(state, n_data: int, level: int = 1) -> Dict[str, Dict]:
    """``{tree: {JAX path: dimension or None}}``: the dimension each leaf
    is sharded along over ``n_data`` ranks, in the port's layout of the
    leaf, for the optimizer's moments (``opt_state``, by their
    parameter's path) and at level 3 the ``params``, ``ema_params`` and
    ``imnet_params`` trees; the other trees of level 1 are whole
    (``zero.py:72-110``)."""
    if level not in (1, 3):
        raise AssertionError(f'zero level must be 1 or 3, got {level}')
    student = state.student
    paths = tp_mod.jax_paths(student)

    def specs(module):
        return {paths[n]: _zero_dim(_whole_shape(p), n_data,
                                    getattr(p, 'tp_dim', None))
                for n, p in module.named_parameters()}

    out = {'opt_state': {paths[n]: d for n, d in
                         ((n, _zero_dim(_whole_shape(p), n_data,
                                        getattr(p, 'tp_dim', None)))
                          for n, p in student.named_parameters()
                          if p.requires_grad)}}
    for tree, attr in _TREES:
        module = getattr(state, attr, None)
        if module is not None:
            out[tree] = specs(module) if level == 3 else \
                {k: None for k in specs(module)}
    return out


def _whole_shape(p) -> tuple:
    """``p``'s shape before ZeRO cut it (a level-3 tensor is empty)."""
    shard = getattr(p, 'zero_shard', None)
    if shard is None or p.numel():
        return tuple(p.shape)
    shape = list(shard.shape)
    shape[p.zero_dim] *= p.zero_n
    return tuple(shape)


def _cut(t: torch.Tensor, dim: int, n: int, index: int) -> torch.Tensor:
    size = t.shape[dim] // n
    return t.narrow(dim, index * size, size)


class ShardedOptimizer(ScheduledOptimizer):
    """A ``ScheduledOptimizer`` whose parameters are ZeRO shards (or,
    under tensor parallelism, a model rank's leaves): ``step`` gathers the
    new parameters, and the checkpoint's entry is whole
    (``whole_entry``). Made from a bound one by ``attach``."""

    sharding = None

    @torch.no_grad()
    def reduce_gradients(self, params) -> None:
        """Each shard's gradient, the data group's mean of its leaf's
        gradient reduce-scattered (the leaf's own gradient then dropped);
        an unsharded leaf's gradient all-reduced to the mean."""
        sh = self.sharding
        n = sh.layout.n_data
        whole = []
        for q in params:
            full = getattr(q, 'zero_full', None)
            if full is None:
                if q.grad is None:
                    q.grad = torch.zeros_like(q)
                whole.append(q.grad)
                continue
            g = full.grad if full.grad is not None else \
                torch.zeros_like(full)
            q.grad = (comm.reduce_scatter(g, sh.layout.data, q.zero_dim)
                      if n > 1 else g.clone()).div_(n)
            full.grad = None
        if whole and n > 1:
            from .mesh import _mean_in_place
            _mean_in_place(whole, sh.layout.data)

    def zero_grad(self):
        super().zero_grad()
        for q in self.params:
            full = getattr(q, 'zero_full', None)
            if full is not None:
                full.grad = None

    @torch.no_grad()
    def step(self) -> bool:
        applied = super().step()
        if self.sharding.level == 1:
            self.sharding.gather_student()
        return applied

    def whole_entry(self) -> Dict:
        """The checkpoint's optimizer entry with every tensor whole, as a
        single-process run writes it; collective (every rank calls it)."""
        sd = self.optimizer.state_dict()
        sh = self.sharding
        for i, q in enumerate(self.params):
            if i not in sd['state']:
                continue
            # state_dict() shares the live state's dicts: copy
            sd['state'][i] = {k: sh.whole(q, v)
                              if isinstance(v, torch.Tensor) and v.ndim
                              else v for k, v in sd['state'][i].items()}
        extra = self.extra_state()
        if extra['acc'] is not None:
            extra['acc'] = [sh.whole(q, a.to(q.device)).cpu()
                            for q, a in zip(self.params, extra['acc'])]
        return {'optimizer': sd,
                'scheduler': self.scheduler.state_dict()
                if self.scheduler is not None else None,
                'optimizer_extra': extra}


class Sharding:
    """What a GSPMD train state (``state.sharding``) holds of its layout:
    the ``Layout2D``, the step's ``GlobalBatch``, the ZeRO level (0 under
    tensor parallelism alone)."""

    def __init__(self, layout: tp_mod.Layout2D, level: int):
        self.layout = layout
        self.level = level
        self.gb = GlobalBatch(layout.data if layout.n_data > 1 else None,
                              layout.model, layout.world)
        self.modules: List[nn.Module] = []

    # -- ZeRO's trees --------------------------------------------------------
    def _params(self, modules=None):
        for m in (modules if modules is not None else self.modules):
            yield from m.parameters()

    @torch.no_grad()
    def gather_student(self) -> None:
        """The student's whole parameters from the optimizer's shards."""
        self._gather(self.modules[:1])

    @torch.no_grad()
    def _gather(self, modules) -> None:
        for p in self._params(modules):
            s = getattr(p, 'zero_shard', None)
            if s is not None:
                p.data = comm.all_gather(s.data, self.layout.data,
                                         p.zero_dim) \
                    if self.layout.n_data > 1 else s.data.clone()

    @torch.no_grad()
    def gather_trees(self) -> None:
        """Level 3: every segmentor whole, for a step or a checkpoint."""
        if self.level == 3:
            self._gather(self.modules)

    @torch.no_grad()
    def release_trees(self) -> None:
        """Level 3: the teacher's new values into its shards (the student's
        are the optimizer's), then every segmentor's tensors dropped."""
        if self.level != 3:
            return
        for i, m in enumerate(self.modules):
            for p in m.parameters():
                s = getattr(p, 'zero_shard', None)
                if s is None:
                    continue
                if i > 0:
                    s.data.copy_(_cut(p.data, p.zero_dim, p.zero_n,
                                      self.layout.data_index))
                p.data = p.data.new_empty(0)

    # -- whole tensors for the checkpoint ------------------------------------
    def whole(self, q, t: torch.Tensor) -> torch.Tensor:
        """A tensor shaped as the optimizer's parameter ``q`` made whole:
        gathered over the data group along ZeRO's dimension, then over the
        model group along the tensor-parallel one."""
        dev = t.device
        t = t.to(q.device)
        dim = getattr(q, 'zero_dim', None)
        if dim is not None and getattr(q, 'zero_full', None) is not None \
                and self.layout.n_data > 1:
            t = comm.all_gather(t, self.layout.data, dim)
        tp_dim = getattr(q, 'tp_dim', None)
        if tp_dim is not None:
            t = tp_mod._whole(t, q.tp_kind, tp_dim, self.layout.model)
        return t.to(dev)

    def whole_state_dict(self, module: nn.Module) -> Dict[str, torch.Tensor]:
        """``module``'s state dict with every parameter whole; collective.
        At level 3 the trees are gathered (and dropped again by the
        caller's ``release_trees``)."""
        sd = module.state_dict()
        if self.layout.n_model > 1:
            sd.update(tp_mod.whole_tensors(
                module, {k: v for k, v in sd.items()
                         if k in dict(module.named_parameters())},
                self.layout.model))
        return sd


def attach(state, layout: tp_mod.Layout2D, level: int):
    """Lay a whole train state, the same on every rank (a resumed one
    included), out over ``layout`` in place: tensor-parallel surgery when
    the layout has a model axis, ZeRO shards at ``level`` 1 or 3, and the
    segmentors split the global batch (``split_forwards``). Sets
    ``state.sharding``."""
    opt = state.optimizer
    if isinstance(opt, dict) or getattr(state, 'disc_optimizer', None):
        raise ValueError('parallel.zero and parallel.tp do not compose with '
                         'a dict-of-optimizers config')
    sh = Sharding(layout, level)
    sh.modules = state_segmentors(state)
    for module in sh.modules:
        split_forwards(module)
        if layout.n_model > 1:
            tp_mod.shard_model(module, layout)
    if layout.n_model > 1:
        tp_mod.cut_optimizer(opt, layout)
    opt.__class__ = ShardedOptimizer
    opt.sharding = sh
    opt.layout = sh.gb
    if level:
        _zero_optimizer(opt, sh)
        if level == 3:
            _zero_frozen(sh)
            sh.release_trees()
    sh.gb.zero = opt if level else None
    state.sharding = sh
    return state


def _mark(q, p, dim, n):
    q.zero_dim = dim
    q.zero_n = n
    q.tp_dim = getattr(p, 'tp_dim', None)
    q.tp_kind = getattr(p, 'tp_kind', None)


@torch.no_grad()
def _zero_optimizer(opt: ShardedOptimizer, sh: Sharding) -> None:
    """The optimizer's parameters become shards of the student's leaves
    (a whole moment of a resumed state cut the same way)."""
    n, index = sh.layout.n_data, sh.layout.data_index
    swap = {}
    for p in opt.params:
        dim = _zero_dim(tuple(p.shape), n, getattr(p, 'tp_dim', None))
        p.zero_dim, p.zero_n = dim, n
        if dim is None:
            continue
        q = nn.Parameter(_cut(p.data, dim, n, index).clone())
        _mark(q, p, dim, n)
        q.zero_full = p
        p.zero_shard = q
        swap[p] = q
    for group in opt.optimizer.param_groups:
        group['params'] = [swap.get(p, p) for p in group['params']]
    for p, q in swap.items():
        st = opt.optimizer.state.pop(p, None)
        if st:
            opt.optimizer.state[q] = {
                k: _cut(v, q.zero_dim, n, index).clone()
                if isinstance(v, torch.Tensor) and v.ndim else v
                for k, v in st.items()}
    if opt.acc is not None:
        opt.acc = [_cut(a, swap[p].zero_dim, n, index).clone()
                   if p in swap else a for p, a in zip(opt.params, opt.acc)]
    opt.params = [swap.get(p, p) for p in opt.params]


@torch.no_grad()
def _zero_frozen(sh: Sharding) -> None:
    """Level 3: the teacher's and the reference's leaves get shards."""
    n, index = sh.layout.n_data, sh.layout.data_index
    for p in sh._params(sh.modules[1:]):
        dim = _zero_dim(tuple(p.shape), n, getattr(p, 'tp_dim', None))
        p.zero_dim, p.zero_n = dim, n
        if dim is not None:
            q = _cut(p.data, dim, n, index).clone()
            p.zero_shard = q


def shard_state(state, layout: Optional[tp_mod.Layout2D] = None,
                level: int = 1):
    """ZeRO-``level`` (1 or 3) over ``layout``'s data group (the default
    group's ranks when None); a 2-D layout adds tensor parallelism
    (``zero.py:113-125``)."""
    if level not in (1, 3):
        raise AssertionError(f'zero level must be 1 or 3, got {level}')
    return attach(state, layout or get_data_layout(), level)


def gather_batch(batch: dict, layout: tp_mod.Layout2D) -> dict:
    """This data index's batch all-gathered over the data group: the
    global batch, in data-rank order."""
    if layout.n_data == 1:
        return batch
    return {k: comm.all_gather(v, layout.data)
            if isinstance(v, torch.Tensor) and v.ndim else v
            for k, v in batch.items()}


def make_global_step(algo, mean, std, sharding: Sharding,
                     collect_vis: bool = False):
    """The GSPMD step of a state laid out by ``attach``: ``(state, batch,
    generator, **kw)``, ``batch`` this data index's rows, ``generator``
    the single-process step's. The batch is all-gathered, the trees
    gathered at level 3, and ``algo``'s step runs with the
    ``GlobalBatch``."""
    inner = algo.make_train_step(mean, std, collect_vis=collect_vis,
                                 group=sharding.gb)

    def step_fn(state, batch, generator, **kwargs):
        batch = gather_batch(batch, sharding.layout)
        sharding.gather_trees()
        try:
            return inner(state, batch, generator, **kwargs)
        finally:
            sharding.release_trees()

    return step_fn


def make_zero_train_step(algo, mean, std, sharding: Sharding,
                         collect_vis: bool = False):
    """The ZeRO step (``zero.py:128-159``) of a state from
    ``shard_state``: ``(state, batch, generator) -> (state, log_vars)``."""
    return make_global_step(algo, mean, std, sharding, collect_vis)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def tree_bytes(module: nn.Module) -> Tuple[int, int]:
    """(bytes ``module``'s parameters occupy on this rank, bytes they would
    occupy whole): summed over the ranks, the JAX audit of the tree
    (``zero.py:175-189``)."""
    stored = whole = 0
    for p in module.parameters():
        s = getattr(p, 'zero_shard', None)
        held = s if s is not None and not p.numel() else p
        stored += _nbytes(held)
        n_model = 1
        if getattr(p, 'tp_dim', None) is not None:
            layout = next((m.tp_group for m in module.modules()
                           if hasattr(m, 'tp_group')), None)
            n_model = dist.get_world_size(layout) if layout is not None \
                else 1
        whole += int(torch.Size(_whole_shape(p)).numel()) * \
            p.element_size() * n_model
    return stored, whole


def opt_state_bytes(optimizer) -> Tuple[int, int]:
    """(bytes of the optimizer's moments and accumulator on this rank,
    bytes they would occupy whole); the per-parameter step counters
    (0-dim) are left out (optax keeps one count a tree)."""
    stored = whole = 0
    tensors = []
    for q in optimizer.params:
        st = optimizer.optimizer.state.get(q) or {}
        tensors += [(q, v) for v in st.values()
                    if isinstance(v, torch.Tensor) and v.ndim]
    if optimizer.acc is not None:
        tensors += list(zip(optimizer.params, optimizer.acc))
    for q, v in tensors:
        stored += _nbytes(v)
        factor = q.zero_n if getattr(q, 'zero_full', None) is not None \
            else 1
        if getattr(q, 'tp_dim', None) is not None:
            factor *= optimizer.sharding.layout.n_model
        whole += _nbytes(v) * factor
    return stored, whole


def whole_copy(state) -> nn.Module:
    """A plain copy of the state's student with its whole weights (no
    split forwards, no tensor-parallel blocks), for evaluation; every rank
    calls it (the gathers are collective)."""
    import copy
    sh = state.sharding
    sh.gather_trees()
    try:
        sd = sh.whole_state_dict(state.student)
    finally:
        sh.release_trees()
    module = copy.deepcopy(state.student)
    for m in module.modules():
        if hasattr(m, 'tp_group'):
            m.__class__ = type(m).__mro__[1]
            del m.tp_group
    if getattr(type(module), 'splits_batch', False):
        module.__class__ = type(module).__mro__[1]
    with torch.no_grad():
        for name, p in module.named_parameters():
            p.data = sd[name].detach().clone()
            for attr in ('zero_shard', 'zero_full', 'zero_dim', 'zero_n',
                         'tp_dim', 'tp_kind'):
                if hasattr(p, attr):
                    delattr(p, attr)
    return module
