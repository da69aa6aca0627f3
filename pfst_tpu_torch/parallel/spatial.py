"""Spatially sharded whole-scene inference (port of the inference half of
``pfst_tpu/parallel/spatial.py``).

The JAX file shards a scene's height (or an (H, W) grid of it) over a
mesh and runs one ``whole``-mode forward; GSPMD inserts the halo
exchanges and the global reductions, so every device holds 1/n of each
activation. Here each rank of a group holds a block of every activation
as a ``Stripe``: a tensor of its block whose ``__torch_function__`` runs
the forward's ops on the blocks and reports the scene's shape
(``x.shape`` is the whole map's, so the segmentor's own code, which
sizes its resizes from shapes, runs unchanged):

* ``conv2d`` and ``max_pool2d`` read the rows (and columns) their
  windows need from the neighbouring blocks, several blocks away when a
  dilation asks for it (ASPP's 36 at 1/8 of 1024² over 4 ranks), zero
  (or minus infinity) beyond the scene's edges, not the block's;
* ``interpolate`` (bilinear, either ``align_corners``, and nearest)
  computes its block's rows at the scene's coordinates, reading the
  source rows it needs across blocks;
* ``adaptive_avg_pool2d`` to 1x1 (the image pool) sums each block and
  ``all_reduce``s the sums; the pooled map is whole (``whole``) on every
  rank until it is resized back to the scene's size;
* every other op acts on the blocks as they are, and raises when it
  would change a block's spatial shape or reorders the spatial dims
  (a flatten, a flip): nothing is computed on the wrong rows.

Every rank computes every rank's needs from the shapes alone, so each
exchange is one ``all_to_all_single`` over the group with the block
pieces each rank needs from each other (staged through the host on gloo
with CUDA tensors, ``comm.py``). A 2-D grid's exchange reads a region
once, corners included. Blocks are cut at multiples of ``ALIGN`` (8, the
leaf config's cumulative stride) of the scene, and the cuts of a map of
each height and width are kept for the whole forward, so maps of one
size are cut alike and a strided window starts where the whole-scene
op's does. Eval-mode BN, the 1x1 convs and the softmax are local.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils._pytree import tree_flatten, tree_unflatten

from . import comm

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
            f'spatial inference: {getattr(func, "__name__", func)} on maps '
            f'of different sizes {sorted({s.hw for s in split})}')
    if func in _SPATIAL_REORDER:
        raise NotImplementedError(
            f'spatial inference: {getattr(func, "__name__", func)} would '
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
            f'spatial inference: {getattr(func, "__name__", func)} gave a '
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
    the scene: one ``all_to_all`` of the pieces each rank needs."""
    grid = x.grid
    h, w = x.hw
    local = x.local()
    b, c = local.shape[:2]
    me = grid.i * grid.n_w + grid.j
    lo, hi, clo, chi = wants[me]
    out = local.new_full((b, c, hi - lo, chi - clo), fill)

    def piece(src_rank, region):
        r0, r1, c0, c1 = grid.block(h, w, src_rank)
        a0, a1 = max(r0, region[0], 0), min(r1, region[1], h)
        b0, b1 = max(c0, region[2], 0), min(c1, region[3], w)
        return (a0, a1, b0, b1) if a0 < a1 and b0 < b1 else None

    mine = grid.block(h, w)
    local_only = all(
        piece(r, wants[r]) is None or
        all(_inside(wants[r], grid.block(h, w, r), h, w))
        for r in range(grid.world))
    if local_only or grid.world == 1:
        p = piece(me, wants[me])
        if p is not None:
            out[:, :, p[0] - lo:p[1] - lo, p[2] - clo:p[3] - clo] = \
                local[:, :, p[0] - mine[0]:p[1] - mine[0],
                      p[2] - mine[2]:p[3] - mine[2]]
        return out
    sends, in_splits = [], []
    for r in range(grid.world):
        p = piece(me, wants[r])
        if p is None:
            in_splits.append(0)
            continue
        t = local[:, :, p[0] - mine[0]:p[1] - mine[0],
                  p[2] - mine[2]:p[3] - mine[2]].reshape(-1)
        sends.append(t)
        in_splits.append(t.numel())
    recvs = [piece(r, wants[me]) for r in range(grid.world)]
    out_splits = [0 if p is None else b * c * (p[1] - p[0]) * (p[3] - p[2])
                  for p in recvs]
    flat = torch.cat(sends) if sends else local.new_empty(0)
    got = comm.all_to_all(flat, grid.group, out_splits, in_splits)
    offset = 0
    for p, n in zip(recvs, out_splits):
        if p is None:
            continue
        out[:, :, p[0] - lo:p[1] - lo, p[2] - clo:p[3] - clo] = \
            got[offset:offset + n].view(b, c, p[1] - p[0], p[3] - p[2])
        offset += n
    return out


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
            raise NotImplementedError(f'spatial inference: conv padding '
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
        raise NotImplementedError('spatial inference: max_pool2d with '
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
        raise NotImplementedError(f'spatial inference: adaptive pool to '
                                  f'{output_size}')
    total = x.local().float().sum(dim=(2, 3), keepdim=True)
    if x.grid.world > 1:
        dist.all_reduce(total, group=x.grid.group)
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
        raise NotImplementedError(f'spatial inference: interpolate '
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


def _spatial_index(x: Stripe, idx, *rest):
    """``x[idx]`` (or ``x[idx] = v``) when ``idx`` leaves the spatial
    dimensions whole."""
    if not x.whole:
        items = idx if isinstance(idx, tuple) else (idx,)
        if any(i is Ellipsis for i in items) or any(
                i != slice(None) for i in items[2:]):
            raise NotImplementedError('spatial inference: indexing a '
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
