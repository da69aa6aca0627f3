"""Spatially sharded whole-scene inference and training (port of
``pfst_tpu/parallel/spatial.py``).

The JAX file shards a scene's height (or an (H, W) grid of it) over a
mesh and runs one ``whole``-mode forward, or one train step; GSPMD
inserts the halo exchanges and the global reductions, so every device
holds 1/n of each activation. Here each rank of a group holds a block of
every activation as a ``Stripe``: a tensor of its block whose
``__torch_function__`` runs the forward's ops on the blocks and reports
the scene's shape (``x.shape`` is the whole map's, so the segmentor's own
code, which sizes its resizes from shapes, runs unchanged):

* ``conv2d`` and ``max_pool2d`` read the rows (and columns) their
  windows need from the neighbouring blocks, several blocks away when a
  dilation asks for it (ASPP's 36 at 1/8 of 1024² over 4 ranks), zero
  (or minus infinity) beyond the scene's edges, not the block's;
* ``interpolate`` (bilinear, either ``align_corners``, and nearest)
  computes its block's rows at the scene's coordinates, reading the
  source rows it needs across blocks;
* ``adaptive_avg_pool2d`` to 1x1 (the image pool) sums each block and
  all-reduces the sums; the pooled map is whole (``whole``) on every
  rank until it is resized back to the scene's size;
* ``batch_norm`` in train mode normalizes by the statistics of every
  block of every data rank (``Grid.bn_world``; a whole map's over the
  data ranks, ``Grid.data_group``), in eval mode by its running ones;
* ``dropout`` and ``dropout2d`` cut each block's mask from the mask
  drawn for the whole global map, the single-process step's;
* every other op acts on the blocks as they are, and raises when it
  would change a block's spatial shape or reorders the spatial dims
  (a flatten, a flip): nothing is computed on the wrong rows.

Every rank computes every rank's needs from the shapes alone, so each
exchange is one ``all_to_all_single`` over the group with the block
pieces each rank needs from each other (``comm.py``). A 2-D grid's
exchange reads a region once, corners included. Blocks are cut at
multiples of ``ALIGN`` (8, the leaf config's cumulative stride) of the
scene, and the cuts of a map of each height and width are kept for the
whole forward, so maps of one size are cut alike and a strided window
starts where the whole-scene op's does. The 1x1 convs and the softmax are
local.

Training runs on the same blocks backward. The exchange is an autograd
function whose backward is the transposed ``all_to_all``: each rank sends
back the gradients of the rows it read, and the owner adds them into its
block. The image pool's sum is ``comm.all_reduce_sum``, whose backward
sums the ranks' gradients. ``make_spatial_train_step`` is the JAX mode:
the single-device step over the global batch, every rank the same, its
segmentors' forwards split into one block a rank and gathered whole
(``SpatialBatch``).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils._pytree import tree_flatten, tree_unflatten

from . import comm
from .global_batch import (GlobalBatch, batch_rows, gather_rows, map_outputs,
                           ones_laid_out_as, split_forwards)
from .sync_bn import cross_replica_batch_norm

DATA_AXIS = 'data'
SPATIAL_AXIS = 'spatial'
SPATIAL_W_AXIS = 'spatial_w'
# the scene's blocks are cut at multiples of this
ALIGN = 8


class Grid:
    """The ranks of ``group`` as an ``(n_h, n_w)`` grid (rank r at row
    ``r // n_w``, column ``r % n_w``, the JAX ``reshape(n_h, n_w)``) and
    the cuts of each map size of one forward."""

    def __init__(self, group, n_h: int, n_w: int = 1, align: int = ALIGN):
        self.group = group
        self.n_h, self.n_w = n_h, n_w
        self.world = n_h * n_w
        rank = dist.get_rank(group) if group is not None else 0
        self.i, self.j = divmod(rank, n_w)
        self.align = align
        self.rows: Dict[int, List[int]] = {}
        self.cols: Dict[int, List[int]] = {}
        # train-mode batch norm: a sharded map's statistics span
        # ``bn_world`` (every block of every data rank), a whole map's the
        # data ranks of this block (none: this rank's own)
        self.bn_world = group
        self.data_group = None

    def scene_cuts(self, size: int, n: int, table: Dict[int, List[int]]):
        """Cut the scene's ``size`` into ``n`` parts at multiples of
        ``align``, as even as that allows."""
        if n == 1:
            table[size] = [0, size]
            return
        cuts = [0] + [min(max(round(k * size / n / self.align) *
                               self.align, 0), size) for k in range(1, n)] \
            + [size]
        if any(b <= a for a, b in zip(cuts, cuts[1:])):
            raise ValueError(f'a scene of {size} does not split into {n} '
                             f'blocks of multiples of {self.align}')
        table[size] = cuts

    def derive(self, table, size: int, cuts: List[int], fn) -> List[int]:
        """The cuts of a map of ``size`` made from one cut at ``cuts``:
        those the forward already gave that size, else ``fn`` of each."""
        if size not in table:
            new = [0] + [min(max(fn(c), 0), size) for c in cuts[1:-1]] + \
                [size]
            if any(b <= a for a, b in zip(new, new[1:])):
                raise ValueError(f'a map of {size} leaves a rank an empty '
                                 f'block ({new}): use fewer ranks or a '
                                 f'larger scene')
            table[size] = new
        return table[size]

    def block(self, h: int, w: int, rank: Optional[int] = None):
        """(r0, r1, c0, c1) of ``rank``'s (this rank's) block of an h x w
        map."""
        i, j = divmod(rank, self.n_w) if rank is not None else (self.i,
                                                                self.j)
        r, c = self.rows[h], self.cols[w]
        return r[i], r[i + 1], c[j], c[j + 1]


_SHAPE_GET = torch.Tensor.shape.__get__


class Stripe(torch.Tensor):
    """This rank's block of a sharded map; ``shape`` and ``size`` report
    the whole map's (module docstring). ``whole`` marks a map every rank
    holds whole (the image pool)."""

    grid: Grid
    hw: Tuple[int, int]
    whole: bool

    @staticmethod
    def wrap(local: torch.Tensor, grid: Grid, hw, whole=False):
        out = local.as_subclass(Stripe)
        out.grid, out.hw, out.whole = grid, tuple(hw), whole
        return out

    def local(self) -> torch.Tensor:
        return self.as_subclass(torch.Tensor)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        with torch._C.DisableTorchFunctionSubclass():
            handler = _HANDLERS.get(func)
            if handler is None and func == _SHAPE_GET:
                handler = _shape
            if handler is not None:
                return handler(*args, **kwargs)
            return _elementwise(func, args, kwargs)


def _stripes(args) -> List[Stripe]:
    flat, _ = tree_flatten(args)
    return [a for a in flat if isinstance(a, Stripe)]


def _shape(x: Stripe):
    local = x.local()
    if x.whole:
        return local.shape
    return torch.Size(tuple(local.shape[:2]) + x.hw)


def _size(x: Stripe, dim=None):
    shape = _shape(x)
    return shape if dim is None else shape[dim]


# the ops that would reorder or mix a block's rows and columns
_SPATIAL_REORDER = {torch.flip, torch.Tensor.flip, torch.roll,
                    torch.Tensor.roll, torch.rot90, torch.Tensor.view,
                    torch.Tensor.reshape, torch.reshape, torch.flatten,
                    torch.Tensor.flatten, torch.Tensor.permute,
                    torch.permute, torch.transpose, torch.Tensor.transpose,
                    torch.Tensor.numpy, torch.Tensor.tolist,
                    torch.Tensor.item, F.unfold, torch.Tensor.unfold}


def _elementwise(func, args, kwargs):
    """An op that acts on each block as it is: the blocks in, the blocks
    out, or a whole map in and out."""
    stripes = _stripes((args, kwargs))
    split = [s for s in stripes if not s.whole]
    if not split:
        flat, spec = tree_flatten((args, kwargs))
        a, k = tree_unflatten([x.local() if isinstance(x, Stripe) else x
                               for x in flat], spec)
        out = func(*a, **k)
        ref = stripes[0]
        return _wrap_results(out, lambda t: Stripe.wrap(
            t, ref.grid, t.shape[2:], whole=True) if t.ndim == 4 else t)
    ref = split[0]
    if any(s.hw != ref.hw or s.grid is not ref.grid for s in split):
        raise NotImplementedError(
            f'spatial sharding: {getattr(func, "__name__", func)} on maps '
            f'of different sizes {sorted({s.hw for s in split})}')
    if func in _SPATIAL_REORDER:
        raise NotImplementedError(
            f'spatial sharding: {getattr(func, "__name__", func)} would '
            f'reorder a sharded map\'s rows or columns')
    grid, (h, w) = ref.grid, ref.hw
    r0, r1, c0, c1 = grid.block(h, w)

    def unwrap(x):
        if isinstance(x, Stripe):
            t = x.local()
            if x.whole and tuple(t.shape[-2:]) == (h, w):
                return t[..., r0:r1, c0:c1]
            return t
        return x

    flat, spec = tree_flatten((args, kwargs))
    a, k = tree_unflatten([unwrap(x) for x in flat], spec)
    out = func(*a, **k)
    block = (r1 - r0, c1 - c0)

    def rewrap(t):
        if t.ndim >= 3 and tuple(t.shape[-2:]) == block:
            return Stripe.wrap(t, grid, (h, w))
        raise NotImplementedError(
            f'spatial sharding: {getattr(func, "__name__", func)} gave a '
            f'tensor of shape {tuple(t.shape)} from blocks of {block}')
    return _wrap_results(out, rewrap)


def _wrap_results(out, fn):
    if isinstance(out, torch.Tensor):
        return fn(out)
    if isinstance(out, (list, tuple)) and any(
            isinstance(o, torch.Tensor) for o in out):
        return type(out)(fn(o) if isinstance(o, torch.Tensor) else o
                         for o in out)
    return out


# -- the exchange ------------------------------------------------------------
def _fetch(x: Stripe, wants, fill: float) -> torch.Tensor:
    """This rank's wanted region of the map ``x`` (global rows and columns
    ``wants[rank] = (lo, hi, clo, chi)``, every rank's), ``fill`` outside
    the scene: one ``all_to_all`` of the pieces each rank needs, and its
    transpose backward."""
    return _Exchange.apply(x.local(), _Plan(x.grid, x.hw, wants), fill)


class _Plan:
    """Who sends which piece of its block to whom for one exchange: the
    same on every rank, from the shapes alone."""

    def __init__(self, grid: Grid, hw, wants):
        h, w = hw
        self.grid = grid
        self.me = grid.i * grid.n_w + grid.j
        self.region = wants[self.me]
        self.mine = grid.block(h, w)

        def piece(src_rank, region):
            r0, r1, c0, c1 = grid.block(h, w, src_rank)
            a0, a1 = max(r0, region[0], 0), min(r1, region[1], h)
            b0, b1 = max(c0, region[2], 0), min(c1, region[3], w)
            return (a0, a1, b0, b1) if a0 < a1 and b0 < b1 else None

        world = grid.world
        self.local_only = world == 1 or all(
            piece(r, wants[r]) is None or
            all(_inside(wants[r], grid.block(h, w, r), h, w))
            for r in range(world))
        # the pieces of this block each rank reads, and those this rank
        # reads of each rank's block, in rank order
        self.sends = [piece(self.me, wants[r]) for r in range(world)]
        self.recvs = [piece(r, self.region) for r in range(world)]

    def in_block(self, p):
        """The slices of the piece ``p`` in this rank's block."""
        r0, _, c0, _ = self.mine
        return (slice(None), slice(None), slice(p[0] - r0, p[1] - r0),
                slice(p[2] - c0, p[3] - c0))

    def in_region(self, p):
        """The slices of the piece ``p`` in this rank's wanted region."""
        lo, _, clo, _ = self.region
        return (slice(None), slice(None), slice(p[0] - lo, p[1] - lo),
                slice(p[2] - clo, p[3] - clo))


def _numel(b: int, c: int, p) -> int:
    return 0 if p is None else b * c * (p[1] - p[0]) * (p[3] - p[2])


class _Exchange(torch.autograd.Function):
    """The region ``plan.region`` of the map whose block is ``local``. The
    backward is the transposed exchange: each rank sends back the
    gradients of the pieces it read, and the owner adds them into its
    block (a piece read by several ranks, its gradients summed)."""

    @staticmethod
    def forward(ctx, local, plan: _Plan, fill: float):
        ctx.plan = plan
        b, c = local.shape[:2]
        lo, hi, clo, chi = plan.region
        out = local.new_full((b, c, hi - lo, chi - clo), fill)
        own = plan.sends[plan.me]
        if plan.local_only:
            if own is not None:
                out[plan.in_region(own)] = local[plan.in_block(own)]
            return out
        got = _all_to_all_pieces(
            [None if p is None else local[plan.in_block(p)]
             for p in plan.sends], plan.recvs, b, c, plan.grid.group,
            local)
        for p, t in zip(plan.recvs, got):
            if p is not None:
                out[plan.in_region(p)] = t
        return out

    @staticmethod
    def backward(ctx, grad):
        plan = ctx.plan
        b, c = grad.shape[:2]
        lo, hi, clo, chi = plan.mine
        g_local = grad.new_zeros((b, c, hi - lo, chi - clo))
        if plan.local_only:
            own = plan.sends[plan.me]
            if own is not None:
                g_local[plan.in_block(own)] += grad[plan.in_region(own)]
            return g_local, None, None
        got = _all_to_all_pieces(
            [None if p is None else grad[plan.in_region(p)]
             for p in plan.recvs], plan.sends, b, c, plan.grid.group, grad)
        for p, t in zip(plan.sends, got):
            if p is not None:
                g_local[plan.in_block(p)] += t
        return g_local, None, None


def _all_to_all_pieces(outgoing, incoming, b: int, c: int, group,
                       like: torch.Tensor) -> List[Optional[torch.Tensor]]:
    """Send ``outgoing[r]`` (a (b, c, h, w) piece, or None) to rank r and
    receive from each rank r a piece of the shape ``incoming[r]`` names:
    one ``all_to_all``."""
    sends = [t.reshape(-1) for t in outgoing if t is not None]
    in_splits = [0 if t is None else t.numel() for t in outgoing]
    out_splits = [_numel(b, c, p) for p in incoming]
    flat = torch.cat(sends) if sends else like.new_empty(0)
    got = comm.all_to_all(flat, group, out_splits, in_splits)
    pieces, offset = [], 0
    for p, n in zip(incoming, out_splits):
        pieces.append(None if p is None else got[offset:offset + n].view(
            b, c, p[1] - p[0], p[3] - p[2]))
        offset += n
    return pieces


def _inside(want, block, h, w):
    """Whether the in-scene part of ``want`` lies in ``block``."""
    lo, hi, clo, chi = want
    r0, r1, c0, c1 = block
    yield max(lo, 0) >= r0 and min(hi, h) <= r1
    yield max(clo, 0) >= c0 and min(chi, w) <= c1


# -- windows: conv and max pool ----------------------------------------------
def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _window_wants(x: Stripe, k, s, p, d, sharded_w: bool):
    """Every rank's input region for its output block of a window op, and
    the output's size; the output's cuts are registered."""
    grid = x.grid
    h, w = x.hw
    ho = (h + 2 * p[0] - d[0] * (k[0] - 1) - 1) // s[0] + 1
    wo = (w + 2 * p[1] - d[1] * (k[1] - 1) - 1) // s[1] + 1
    grid.derive(grid.rows, ho, grid.rows[h], lambda c: -(-c // s[0]))
    grid.derive(grid.cols, wo, grid.cols[w], lambda c: -(-c // s[1]))
    wants = []
    for r in range(grid.world):
        o0, o1, q0, q1 = grid.block(ho, wo, r)
        lo = o0 * s[0] - p[0]
        hi = (o1 - 1) * s[0] - p[0] + d[0] * (k[0] - 1) + 1
        if sharded_w:
            clo = q0 * s[1] - p[1]
            chi = (q1 - 1) * s[1] - p[1] + d[1] * (k[1] - 1) + 1
        else:
            clo, chi = 0, w
        wants.append((lo, hi, clo, chi))
    return wants, (ho, wo)


def _conv2d(input, weight, bias=None, stride=1, padding=0, dilation=1,
            groups=1):
    x = input
    k = tuple(weight.shape[2:])
    s, d = _pair(stride), _pair(dilation)
    if isinstance(padding, str):
        if padding == 'valid':
            padding = 0
        elif padding == 'same' and s == (1, 1) and \
                all(di * (ki - 1) % 2 == 0 for di, ki in zip(d, k)):
            padding = tuple(di * (ki - 1) // 2 for di, ki in zip(d, k))
        else:
            raise NotImplementedError(f'spatial sharding: conv padding '
                                      f'{padding!r} with stride {s}')
    p = _pair(padding)
    if x.whole:
        out = F.conv2d(x.local(), weight, bias, s, p, d, groups)
        return Stripe.wrap(out, x.grid, out.shape[2:], whole=True)
    sharded_w = x.grid.n_w > 1
    if k == (1, 1) and s == (1, 1) and p == (0, 0):
        out = F.conv2d(x.local(), weight, bias, 1, 0, 1, groups)
        return Stripe.wrap(out, x.grid, x.hw)
    wants, hw = _window_wants(x, k, s, p, d, sharded_w)
    region = _fetch(x, wants, 0.0)
    out = F.conv2d(region, weight, bias, s, (0, 0 if sharded_w else p[1]),
                   d, groups)
    return Stripe.wrap(out, x.grid, hw)


def _max_pool2d(input, kernel_size, stride=None, padding=0, dilation=1,
                ceil_mode=False, return_indices=False):
    x = input
    if x.whole:
        out = F.max_pool2d(x.local(), kernel_size, stride, padding,
                           dilation, ceil_mode, return_indices)
        return Stripe.wrap(out, x.grid, out.shape[2:], whole=True)
    if ceil_mode or return_indices:
        raise NotImplementedError('spatial sharding: max_pool2d with '
                                  'ceil_mode or indices')
    k = _pair(kernel_size)
    s = _pair(stride if stride else kernel_size)
    p, d = _pair(padding), _pair(dilation)
    sharded_w = x.grid.n_w > 1
    wants, hw = _window_wants(x, k, s, p, d, sharded_w)
    region = _fetch(x, wants, -math.inf)
    out = F.max_pool2d(region, k, s, (0, 0 if sharded_w else p[1]), d)
    return Stripe.wrap(out, x.grid, hw)


# -- the global pool ---------------------------------------------------------
def _adaptive_avg_pool2d(input, output_size):
    x = input
    if x.whole:
        out = F.adaptive_avg_pool2d(x.local(), output_size)
        return Stripe.wrap(out, x.grid, out.shape[2:], whole=True)
    if _pair(output_size) != (1, 1):
        raise NotImplementedError(f'spatial sharding: adaptive pool to '
                                  f'{output_size}')
    total = x.local().float().sum(dim=(2, 3), keepdim=True)
    if x.grid.world > 1:
        total = comm.all_reduce_sum(total, x.grid.group)
    out = (total / (x.hw[0] * x.hw[1])).to(x.dtype)
    return Stripe.wrap(out, x.grid, (1, 1), whole=True)


# -- resizes ------------------------------------------------------------------
def _taps(out0: int, out1: int, n_in: int, n_out: int, mode: str,
          align_corners: Optional[bool], device):
    """The source indices and weights of output rows [out0, out1): torch's
    ``upsample_bilinear2d`` / ``upsample_nearest2d`` arithmetic, in fp32,
    at the scene's coordinates."""
    dst = torch.arange(out0, out1, device=device, dtype=torch.float32)
    if mode == 'nearest':
        scale = torch.tensor(n_in / n_out, dtype=torch.float32)
        i0 = torch.clamp(torch.floor(dst * scale).long(), max=n_in - 1)
        return i0, i0, torch.zeros_like(dst)
    if align_corners:
        scale = (n_in - 1) / (n_out - 1) if n_out > 1 else 0.0
        src = dst * torch.tensor(scale, dtype=torch.float32)
    else:
        scale = torch.tensor(n_in / n_out, dtype=torch.float32)
        src = torch.clamp(scale * (dst + 0.5) - 0.5, min=0.0)
    i0 = src.long()
    i1 = i0 + (i0 < n_in - 1).long()
    return i0, i1, src - i0.float()


def _lerp_axis(t: torch.Tensor, dim: int, i0, i1, lam, base: int):
    a = t.index_select(dim, i0 - base)
    b = t.index_select(dim, i1 - base)
    shape = [1] * t.ndim
    shape[dim] = -1
    lam = lam.view(shape).to(t.dtype)
    return (1.0 - lam) * a + lam * b


def _interpolate(input, size=None, scale_factor=None, mode='nearest',
                 align_corners=None, recompute_scale_factor=None,
                 antialias=False):
    x = input
    if size is None or antialias or mode not in ('bilinear', 'nearest'):
        raise NotImplementedError(f'spatial sharding: interpolate '
                                  f'{mode} without a size')
    grid = x.grid
    ho, wo = _pair(size)
    h, w = tuple(x.local().shape[2:]) if x.whole else x.hw
    # a whole map's resize is cut as the scene is, scaled
    bh, bw = grid.scene if x.whole else (h, w)
    grid.derive(grid.rows, ho, grid.rows[bh], lambda c: round(c * ho / bh))
    grid.derive(grid.cols, wo, grid.cols[bw], lambda c: round(c * wo / bw))
    dev = x.device
    wants, taps = [], []
    for r in range(grid.world):
        o0, o1, q0, q1 = grid.block(ho, wo, r)
        ti = _taps(o0, o1, h, ho, mode, align_corners, dev)
        tj = _taps(q0, q1, w, wo, mode, align_corners, dev)
        wants.append((int(ti[0].min()), int(ti[1].max()) + 1,
                      int(tj[0].min()), int(tj[1].max()) + 1))
        taps.append((ti, tj))
    me = grid.i * grid.n_w + grid.j
    lo, _, clo, _ = wants[me]
    if x.whole:
        region = x.local()[:, :, lo:wants[me][1], clo:wants[me][3]]
    else:
        region = _fetch(x, wants, 0.0)
    (i0, i1, li), (j0, j1, lj) = taps[me]
    out = _lerp_axis(region, 3, j0, j1, lj, clo)
    out = _lerp_axis(out, 2, i0, i1, li, lo)
    return Stripe.wrap(out.contiguous(), grid, (ho, wo))


# -- train mode: batch norm and dropout ---------------------------------------
def _batch_norm(input, running_mean, running_var, weight=None, bias=None,
                training=False, momentum=0.1, eps=1e-5):
    """Eval mode: each block by the running statistics. Train mode: by the
    statistics of every block of every data rank (a whole map's: of the
    data ranks), the two-pass variance of ``sync_bn.py``, whose backward
    all-reduces both gradient sums; the running statistics move once, by
    the global count's n/(n-1)."""
    x = input
    if not training:
        return _elementwise(F.batch_norm, (x, running_mean, running_var,
                                           weight, bias, training, momentum,
                                           eps), {})
    grid = x.grid
    group = grid.data_group if x.whole else grid.bn_world
    local = x.local()
    if group is None or dist.get_world_size(group) == 1:
        out = F.batch_norm(local, running_mean, running_var, weight, bias,
                           True, momentum, eps)
    else:
        out = cross_replica_batch_norm(local, running_mean, running_var,
                                       weight, bias, momentum, eps, group)
    return Stripe.wrap(out, grid, out.shape[2:] if x.whole else x.hw,
                       whole=x.whole)


def _drop(x: Stripe, p: float, training: bool, feature: bool):
    """``x`` times this block's cut of the mask the single-process step
    draws for the whole global map (``global_batch.batch_rows``), from the
    same generator."""
    if not training or p == 0.0:
        return x
    local = x.local()
    total, rows = batch_rows(local.shape[0])
    c = local.shape[1]
    if feature:
        # one draw an image and channel, alike on every block
        mask = F.dropout2d(local.new_ones((total, c, 1, 1)), p, True)
        out = local * mask[rows]
    else:
        h, w = tuple(local.shape[2:]) if x.whole else x.hw
        mask = F.dropout(ones_laid_out_as(local, (total, c, h, w)), p, True)
        if x.whole:
            out = local * mask[rows]
        else:
            r0, r1, c0, c1 = x.grid.block(h, w)
            out = local * mask[rows, :, r0:r1, c0:c1]
    return Stripe.wrap(out, x.grid, out.shape[2:] if x.whole else x.hw,
                       whole=x.whole)


def _dropout(input, p=0.5, training=True, inplace=False):
    return _drop(input, p, training, feature=False)


def _dropout2d(input, p=0.5, training=True, inplace=False):
    return _drop(input, p, training, feature=True)


def _spatial_index(x: Stripe, idx, *rest):
    """``x[idx]`` (or ``x[idx] = v``) when ``idx`` leaves the spatial
    dimensions whole."""
    if not x.whole:
        items = idx if isinstance(idx, tuple) else (idx,)
        if any(i is Ellipsis for i in items) or any(
                i != slice(None) for i in items[2:]):
            raise NotImplementedError('spatial sharding: indexing a '
                                      'sharded map\'s rows or columns')
    return None


def _getitem(x, idx):
    _spatial_index(x, idx)
    return _elementwise(torch.Tensor.__getitem__, (x, idx), {})


def _setitem(x, idx, value):
    _spatial_index(x, idx)
    return _elementwise(torch.Tensor.__setitem__, (x, idx, value), {})


_HANDLERS = {
    torch.Tensor.size: _size,
    torch.Tensor.__getitem__: _getitem,
    torch.Tensor.__setitem__: _setitem,
    F.conv2d: _conv2d,
    torch.conv2d: _conv2d,
    F.max_pool2d: _max_pool2d,
    torch.max_pool2d: _max_pool2d,
    F.adaptive_avg_pool2d: _adaptive_avg_pool2d,
    F.interpolate: _interpolate,
    F.batch_norm: _batch_norm,
    F.dropout: _dropout,
    F.dropout2d: _dropout2d,
}


# -- the entry points ---------------------------------------------------------
def scatter_scene(scene: torch.Tensor, grid: Grid) -> Stripe:
    """This rank's block of ``scene`` (B, C, H, W), the scene's cuts
    registered."""
    h, w = scene.shape[2:]
    grid.scene = (h, w)
    grid.scene_cuts(h, grid.n_h, grid.rows)
    grid.scene_cuts(w, grid.n_w, grid.cols)
    r0, r1, c0, c1 = grid.block(h, w)
    return Stripe.wrap(scene[:, :, r0:r1, c0:c1].contiguous(), grid, (h, w))


def gather_stripes(x: Stripe, dst: Optional[int] = None) -> torch.Tensor:
    """The whole map of the blocks ``x``, on every rank (or on rank
    ``dst`` of the group only; the others get None)."""
    grid = x.grid
    h, w = x.hw
    full = (0, h, 0, w)
    wants = [full if dst is None or r == dst else (0, 0, 0, 0)
             for r in range(grid.world)]
    out = _fetch(x, wants, 0.0)
    me = grid.i * grid.n_w + grid.j
    return out if dst is None or me == dst else None


def spatial_inference(model, scene: torch.Tensor, group=None,
                      grid: Optional[Sequence[int]] = None,
                      softmax: bool = True, dst: Optional[int] = None):
    """scene (C, H, W) or (B, C, H, W), normalized, the same on every rank
    of ``group`` (the default group, every rank a stripe of H) -> the
    whole-mode probabilities (``softmax=False``: the pre-softmax logits)
    at the scene's size, fp32, whole on every rank (on rank ``dst`` only,
    None elsewhere, when given) (``spatial.py:31-112``).

    ``grid=(n_h, n_w)`` lays the group's ranks out as an H x W grid of
    blocks instead. The model runs in its current mode (eval: its batch
    norms use their running statistics, which no block changes)."""
    group = group if group is not None else (
        dist.group.WORLD if dist.is_available() and dist.is_initialized()
        else None)
    world = dist.get_world_size(group) if group is not None else 1
    n_h, n_w = tuple(grid) if grid is not None else (world, 1)
    if n_h * n_w != world:
        raise ValueError(f'grid {n_h}x{n_w} on a group of {world} ranks')
    batched = scene.ndim == 4
    if not batched:
        scene = scene[None]
    layout = Grid(group, n_h, n_w)
    with torch.inference_mode():
        x = scatter_scene(scene, layout)
        method = model.inference if softmax else model.inference_logits
        out, _ = method(x)
        out = gather_stripes(out, dst)
    if out is None:
        return None
    out = out.as_subclass(torch.Tensor).float()
    return out if batched else out[0]


def make_spatial_inference_fn(model, n_spatial: int, group=None,
                              dst: Optional[int] = 0):
    """``img (1, C, H, W) -> logits`` with the height sharded over the
    ``n_spatial`` ranks of ``group`` (``pfst_tpu/apis/test.py:44-70``): a
    height that does not divide by ``n_spatial`` is edge-padded and the
    logits cropped back; as in the JAX function, the padded rows enter the
    image pool. The logits land on rank ``dst`` (None elsewhere)."""
    group = group if group is not None else dist.group.WORLD
    world = dist.get_world_size(group)
    if n_spatial != world:
        raise ValueError(f'spatial={n_spatial} on a group of {world} '
                         f'ranks')

    def infer(img):
        h = img.shape[2]
        pad = (-h) % n_spatial
        if pad:
            img = F.pad(img, (0, 0, 0, pad), mode='replicate')
        logits = spatial_inference(model, img, group, softmax=False,
                                   dst=dst)
        if logits is None:
            return None
        return logits[:, :, :h] if pad else logits

    return infer


# -- spatially sharded training ------------------------------------------------
class SpatialLayout:
    """The ranks of a spatially sharded train step (``get_spatial_mesh``,
    ``spatial.py:115-136``): rank r of ``world`` is data index
    ``r // (n_h * n_w)`` and spatial position ``r % (n_h * n_w)``, at row
    ``position // n_w`` and column ``position % n_w`` of its data index's
    ``Grid``. ``spatial`` is the group of this data index's spatial ranks,
    ``data`` that of the data ranks at this rank's spatial position (None
    for one data index)."""

    def __init__(self, world, spatial, data, n_data: int, n_h: int,
                 n_w: int, data_index: int, position: int):
        self.world, self.spatial, self.data = world, spatial, data
        self.n_data, self.n_h, self.n_w = n_data, n_h, n_w
        self.data_index, self.position = data_index, position

    def grid(self) -> Grid:
        """A fresh ``Grid`` of this data index's blocks, its batch norms
        reducing over every rank (a whole map's over the data ranks)."""
        grid = Grid(self.spatial, self.n_h, self.n_w)
        grid.bn_world = self.world
        grid.data_group = self.data
        return grid


def get_spatial_layout(n_spatial: int, n_spatial_w: int = 1,
                       group=None) -> SpatialLayout:
    """The ``(data, spatial[, spatial_w])`` layout of the ranks of
    ``group`` (the default group): ``n_spatial`` ranks along the crop's
    height, ``n_spatial_w`` along its width, the rest data indices. Every
    rank of ``group`` must call it, in the same order as the others."""
    group = group if group is not None else dist.group.WORLD
    ranks = comm.group_ranks(group)
    n = len(ranks)
    total = n_spatial * n_spatial_w
    if n % total:
        raise AssertionError(f'{n} devices not divisible by sp={n_spatial}'
                             f'x spw={n_spatial_w}')
    me = dist.get_rank(group)
    n_data = n // total
    spatial = data = None
    for d in range(n_data):
        g = dist.new_group(ranks[d * total:(d + 1) * total])
        if me // total == d:
            spatial = g
    for pos in range(total):
        g = dist.new_group([ranks[d * total + pos] for d in range(n_data)])
        if me % total == pos:
            data = g
    return SpatialLayout(group, spatial, data if n_data > 1 else None,
                         n_data, n_spatial, n_spatial_w, me // total,
                         me % total)


def _check_divisible(batch: dict, layout: SpatialLayout):
    """The JAX asserts (``spatial.py:160-164``): every array of three or
    more dims has a height divisible by sp and a width by spw."""
    for k, v in batch.items():
        if isinstance(v, torch.Tensor) and v.ndim >= 3:
            h, w = v.shape[-2:]
            if h % layout.n_h:
                raise AssertionError(f'{k}: H={h} not divisible by '
                                     f'sp={layout.n_h}')
            if w % layout.n_w:
                raise AssertionError(f'{k}: W={w} not divisible by '
                                     f'spw={layout.n_w}')


def shard_spatial_batch(batch: dict, layout: SpatialLayout) -> dict:
    """This rank's block of this data index's ``batch`` (NCHW images,
    (B, H, W) labels): of every tensor of three or more dims, the
    ``H / sp`` rows and ``W / spw`` columns of its spatial position;
    scalars and 1-D tensors whole (``shard_spatial_batch``,
    ``spatial.py:150-175``)."""
    _check_divisible(batch, layout)
    i, j = divmod(layout.position, layout.n_w)
    out = {}
    for k, v in batch.items():
        if isinstance(v, torch.Tensor) and v.ndim >= 3:
            bh, bw = v.shape[-2] // layout.n_h, v.shape[-1] // layout.n_w
            out[k] = v[..., i * bh:(i + 1) * bh,
                       j * bw:(j + 1) * bw].contiguous()
        else:
            out[k] = v
    return out


def gather_spatial_batch(blocks: dict, layout: SpatialLayout) -> dict:
    """This data index's batch from its ranks' ``shard_spatial_batch``
    blocks: each tensor's blocks gathered over the spatial group and put
    in their places."""
    out = {}
    for k, v in blocks.items():
        if not (isinstance(v, torch.Tensor) and v.ndim >= 3):
            out[k] = v
            continue
        parts = comm.all_gather(v[None], layout.spatial)
        rows = [torch.cat(list(parts[i * layout.n_w:(i + 1) * layout.n_w]),
                          dim=-1) for i in range(layout.n_h)]
        out[k] = torch.cat(rows, dim=-2)
    return out


class SpatialBatch(GlobalBatch):
    """The ``GlobalBatch`` of a spatially sharded step: a split forward
    takes this data index's rows of its input and this rank's block of
    them, runs the segmentor on ``Stripe`` blocks forward and backward,
    and gathers its outputs whole (``gather_stripes``), then over the
    data ranks.

    Every rank computes the same loss on the gathered maps, so a
    parameter's gradient is the sum of its blocks' partial gradients: the
    gather's backward hands each block the gradient of every rank's read
    of it (the group's size times its own) and the data gather its rows'
    times the data ranks, and ``average_gradients`` takes the mean over
    every rank, which is that sum. Batch norms reduce over the blocks
    (``_batch_norm``), not through ``SyncBatchNorm``. The spatial ranks
    hold every leaf replicated, as the model ranks of tensor parallelism
    hold a replicated one, so a gradient's norm counts on the first."""

    def __init__(self, layout: SpatialLayout):
        super().__init__(layout.data, None, layout.world)
        self.layout = layout
        self.model_index = layout.position

    @property
    def bn_group(self):
        return None

    def split_call(self, fn, img, *args, **kwargs):
        rows = self.rows(img.shape[0])
        self.depth += 1
        try:
            x = scatter_scene(img[rows], self.layout.grid())
            out = fn(x, *args, **kwargs)
        finally:
            self.depth -= 1

        def whole(t):
            t = gather_stripes(t) if isinstance(t, Stripe) and not t.whole \
                else t.as_subclass(torch.Tensor)
            return gather_rows(t, self) if self.n_data > 1 else t

        return map_outputs(out, whole, rows.stop - rows.start)

    def average_gradients(self, params) -> None:
        """The sum of the blocks' partial gradients: the mean over every
        rank (class docstring)."""
        params = list(params)
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        from .mesh import _mean_in_place
        with torch.no_grad():
            _mean_in_place([p.grad for p in params], self.world)


def attach(state):
    """Make a whole train state's segmentors split their forwards in a
    spatial step (``split_forwards``), in place. The state stays whole and
    the same on every rank, its gradients whole after the step's
    ``average_gradients``, so the optimizer's clip and non-finite check
    read them as a single process does."""
    from .zero import state_segmentors
    for module in state_segmentors(state):
        split_forwards(module)
    return state


def make_spatial_global_step(algo, mean, std, layout: SpatialLayout,
                             collect_vis: bool = False):
    """The spatially sharded step on this data index's whole batch, as the
    loop's loader gives it: ``(state, batch, generator, **kw)``. The
    batch's rows are gathered over the data ranks and ``algo``'s step runs
    with the ``SpatialBatch``: the single-device step over the global
    batch, whole-batch BN, one block of every activation a rank (the
    state's segmentors split their forwards from the first step on,
    ``attach``). The JAX step turns its merged student pass off for more
    than one data index; the port's passes are sequential anyway (ROADMAP
    C2)."""
    inner = algo.make_train_step(mean, std, collect_vis=collect_vis,
                                 group=SpatialBatch(layout))

    def step_fn(state, batch, generator, **kwargs):
        _check_divisible(batch, layout)
        attach(state)
        if layout.n_data > 1:
            batch = {k: comm.all_gather(v, layout.data)
                     if isinstance(v, torch.Tensor) and v.ndim >= 3 else v
                     for k, v in batch.items()}
        return inner(state, batch, generator, **kwargs)

    return step_fn


def make_spatial_train_step(algo, mean, std, layout: SpatialLayout,
                            collect_vis: bool = False):
    """The spatially sharded step with the JAX mode's signature
    (``make_spatial_train_step``, ``spatial.py:178-239``): ``(state,
    blocks, generator, **kw)``, ``blocks`` this rank's
    ``shard_spatial_batch`` of its data index's batch, ``generator`` the
    single-process step's (the JAX step's random numbers are replicated).
    The blocks are gathered over the spatial group, then
    ``make_spatial_global_step`` runs."""
    step = make_spatial_global_step(algo, mean, std, layout, collect_vis)

    def step_fn(state, blocks, generator, **kwargs):
        return step(state, gather_spatial_batch(blocks, layout), generator,
                    **kwargs)

    return step_fn
