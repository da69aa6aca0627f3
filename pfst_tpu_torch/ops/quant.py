"""Int8 quantization of the inference path, quantization-aware training
and activation calibration (port of ``pfst_tpu/ops/quant.py``).

The JAX file intercepts every flax ``nn.Conv`` / ``nn.Dense`` call. The
port computes those layers by ``F.conv2d`` and ``F.linear``, not always
inside an ``nn.Conv2d`` or ``nn.Linear`` forward (MiT runs its stacked
q|k|v in-projection and its Mix-FFN's 1x1 convs by ``F.linear`` on views
of the weights), so the contexts here are a ``TorchFunctionMode`` that
catches those two functions and keys each call by its weight: the
parameter (or the row block of a stacked one, ``q|k|v``) is named by its
JAX module path, the ``param_paths`` name of its kernel without
``/kernel`` (``core/optimizers.py``). ``skip`` patterns and ``act_scales``
tables keep their keys across the two packages. A weight that is not a
parameter of a segmentor or discriminator (PointRend's dynamic kernels)
is left as it is, and so is a module marked ``int8_exempt`` (the
ResNet's ``s2d_stem`` conv, which the JAX file computes outside
``nn.Conv``). Attention products, norms and the flash kernels are not
touched, as in the JAX file.

The arithmetic is the JAX file's step for step, so the int8 operands are
equal bit for bit: ``a_s = a_scale / 127``, ``qx = clip(round(x / a_s),
-127, 127)`` (half to even, as ``jnp.round``), one activation scale per
tensor (a calibrated one, or the dynamic ``max(max|x|, 1e-12)``, kept on
the device; a calibrated one divides as the compiled JAX program does,
by its reciprocal), one weight scale per output channel (``max(max|w| /
127, 1e-12)``; QAT takes ``max(max|w|, 1e-12) / 127``), the integer sums
rescaled by ``a_s * w_s`` in fp32, the bias added, and the result cast to
the input's type, or to autocast's where autocast is on.

The integer sums have a plain version and a card route, as each kernel
of the port has. On the CPU the product runs in float64 on the int8
operands, which is exact for any K here (``plain_int_conv2d``,
``plain_int_linear``). On the card the sums are int32: a dense conv is
an im2col gathered by ``as_strided`` from the zero-padded NHWC int8 input
and ``torch._int_mm`` (cuBLASLt's int8 product; K and N zero-padded to
multiples of 8, M past 16, which is exact), a Dense the same product; a
grouped or depthwise conv sums its taps and input channels in int32
elementwise products (``cuda_int_conv2d``). An fp32 sum of int8 products
is exact only below 2^24, which a 3x3x512 conv's K = 4608 passes, so no
float product is used for them. On a CUDA tensor the route runs or
raises; nothing reaches the float64 version there.
"""
from __future__ import annotations

import contextlib
import fnmatch
import weakref
from typing import Callable, Dict, Iterable, List, Optional

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

DEFAULT_SKIP = ('*conv_seg*',)

# the calls of the card route, by kind: 'int_mm' (a dense conv or a
# Dense through torch._int_mm), 'grouped' (a grouped or depthwise conv
# in int32 products)
launches = {'int_mm': 0, 'grouped': 0}

# every live segmentor and discriminator (``track_root``): the modules
# whose parameters the contexts name
_ROOTS: 'weakref.WeakSet' = weakref.WeakSet()


def track_root(module):
    """Register ``module`` as a root whose parameters the contexts name
    by their JAX paths; segmentors and discriminators call it from
    ``__new__``, so copies (``copy.deepcopy``: an EMA teacher) are
    registered too."""
    _ROOTS.add(module)
    _INDEX.unknown.clear()
    return module


def _should_skip(path: str, skip: Iterable[str]) -> bool:
    return any(fnmatch.fnmatch(path, pat) for pat in skip)


def _blocks_of(path: str, rows: int):
    """``[(start, stop, module path)]`` of a weight of ``rows`` output
    rows whose JAX kernel path is ``path``: one block, or one a name of a
    stacked ``a|b|c`` element, in its order."""
    parts = path[:-len('/kernel')].split('/')
    idx = next((i for i, s in enumerate(parts) if '|' in s), None)
    if idx is None:
        return [(0, rows, '/'.join(parts))]
    names = parts[idx].split('|')
    n = rows // len(names)
    return [(i * n, (i + 1) * n,
             '/'.join(parts[:idx] + [name] + parts[idx + 1:]))
            for i, name in enumerate(names)]


class _Index:
    """Parameter -> its blocks, built from the roots and kept by the
    parameter's id (tensors compare elementwise, so no weak dictionary
    keyed by them); rebuilt when a parameter is met that it does not
    hold."""

    def __init__(self):
        self.table: Dict[int, tuple] = {}
        self.unknown: Dict[int, 'weakref.ref'] = {}

    def refresh(self):
        from ..core.convert import key_families
        from ..core.optimizers import param_paths
        table = {}
        for root in list(_ROOTS):
            if '_parameters' not in root.__dict__:   # still in __init__
                continue
            exempt = {id(p) for m in root.modules()
                      if getattr(m, 'int8_exempt', False)
                      for p in m.parameters(recurse=False)}
            named = list(root.named_parameters())
            paths = param_paths(named, **key_families(root))
            for name, p in named:
                path = paths[name]
                if path.endswith('/kernel') and id(p) not in exempt:
                    table[id(p)] = (weakref.ref(p),
                                    _blocks_of(path, p.shape[0]))
        self.table = table

    def _entry(self, base):
        hit = self.table.get(id(base))
        if hit is not None and hit[0]() is base:
            return hit[1]
        miss = self.unknown.get(id(base))
        if miss is not None and miss() is base:
            return None
        self.refresh()
        hit = self.table.get(id(base))
        if hit is not None and hit[0]() is base:
            return hit[1]
        self.unknown[id(base)] = weakref.ref(base)
        return None

    def lookup(self, w) -> Optional[List[tuple]]:
        """The blocks of the rows of ``w`` (a parameter, or a view of one
        that takes whole rows), as ``(start, stop, path)`` in ``w``'s own
        rows, or None for a weight no root names."""
        base = w if isinstance(w, torch.nn.Parameter) else w._base
        if not isinstance(base, torch.nn.Parameter):
            return None
        blocks = self._entry(base)
        if blocks is None:
            return None
        if w is base:
            return blocks
        row = base[0].numel()
        offset = w.storage_offset() - base.storage_offset()
        if offset % row or w[0].numel() != row or (
                w.shape[0] > 1 and w.stride(0) != row):
            raise ValueError(f'a weight view of {blocks[0][2]} that does not '
                             f'take whole rows: {tuple(w.shape)}')
        start, stop = offset // row, offset // row + w.shape[0]
        out = []
        for b0, b1, path in blocks:
            if b1 <= start or b0 >= stop:
                continue
            if b0 < start or b1 > stop:
                raise ValueError(f'a weight view splits the rows of {path}')
            out.append((b0 - start, b1 - start, path))
        return out


_INDEX = _Index()


def _conv_args(args, kwargs):
    names = ('input', 'weight', 'bias', 'stride', 'padding', 'dilation',
             'groups')
    defaults = (None, None, None, 1, 0, 1, 1)
    got = dict(zip(names, defaults))
    got.update(zip(names, args))
    got.update(kwargs)
    for k in ('stride', 'padding', 'dilation'):
        v = got[k]
        if isinstance(v, str):
            raise NotImplementedError(f'string padding {v!r} under the '
                                      f'int8 contexts')
        got[k] = (v, v) if isinstance(v, int) else tuple(v)
    return got


def _linear_args(args, kwargs):
    got = dict(zip(('input', 'weight', 'bias'), (None, None, None)))
    got.update(zip(('input', 'weight', 'bias'), args))
    got.update(kwargs)
    return got


def _out_dtype(x):
    if torch.is_autocast_enabled(x.device.type):
        return torch.get_autocast_dtype(x.device.type)
    return x.dtype


def _on_grid(v, a_s, static):
    """``v / a_s``, as the JAX program computes it: XLA folds the division
    by a constant (a calibrated scale) into a product with its fp32
    reciprocal, which rounds otherwise at some halves (37.499996 against
    37.500000), so a static scale multiplies by ``1 / a_s``."""
    return v * (1.0 / a_s) if static else v / a_s


def quantize_activation(x, a_scale, static: bool = False):
    """``(qx, a_s)``: x on the int8 grid of ``a_scale / 127``; ``static``:
    a calibrated scale (``_on_grid``)."""
    a_s = a_scale.float() / 127.0
    qx = torch.clamp(torch.round(_on_grid(x.float(), a_s, static)), -127,
                     127).to(torch.int8)
    return qx, a_s


def quantize_weight(w):
    """``(qw, w_s)``: ``w`` on the int8 grid of one scale an output
    channel (dim 0), ``max(max|w| / 127, 1e-12)``."""
    dims = tuple(range(1, w.dim()))
    w_s = torch.clamp_min(w.detach().abs().amax(dim=dims) / 127.0, 1e-12)
    view = w_s.view(-1, *([1] * (w.dim() - 1)))
    qw = torch.clamp(torch.round(w.detach().float() / view), -127,
                     127).to(torch.int8)
    return qw, w_s


def dynamic_scale(x):
    """``max(max|x|, 1e-12)`` in fp32, on ``x``'s device."""
    return torch.clamp_min(x.detach().abs().amax(), 1e-12).float()


# ----------------------------------------------------------------------
# the integer product: plain version (float64) and the card route (int32)

def plain_int_conv2d(qx, qw, stride, padding, dilation, groups):
    """The exact sums of an int8 conv in float64 (K * 127^2 < 2^53)."""
    with torch.autocast(qx.device.type, enabled=False):
        return F.conv2d(qx.double(), qw.double(), None, stride, padding,
                        dilation, groups)


def plain_int_linear(qx, qw):
    """The exact sums of an int8 Dense in float64."""
    with torch.autocast(qx.device.type, enabled=False):
        return F.linear(qx.double(), qw.double())


def _pad_to(t, rows, cols):
    """``t`` (2-D) zero-padded at its end to (rows, cols)."""
    if tuple(t.shape) == (rows, cols):
        return t.contiguous()
    out = t.new_zeros(rows, cols)
    out[:t.shape[0], :t.shape[1]] = t
    return out


def cuda_int_mm(a, b):
    """int32 ``a @ b.T`` for int8 ``a`` (M, K) and ``b`` (N, K) on the card
    through ``torch._int_mm``: K and N zero-padded to multiples of 8 and M
    past 16 (exact)."""
    m, k = a.shape
    n = b.shape[0]
    kp = max(-(-k // 8) * 8, 16)
    np_ = -(-n // 8) * 8
    mp = max(m, 17)
    launches['int_mm'] += 1
    y = torch._int_mm(_pad_to(a, mp, kp), _pad_to(b, np_, kp).t())
    return y[:m, :n]


def _out_size(size, k, s, p, d):
    return (size + 2 * p - d * (k - 1) - 1) // s + 1


def cuda_int_conv2d(qx, qw, stride, padding, dilation, groups):
    """int32 sums of an int8 conv on the card: groups == 1 as an im2col
    (NHWC, taps then channels) and ``cuda_int_mm``; grouped and depthwise
    convs as int32 products summed over taps and a group's channels."""
    n, c, h, w = qx.shape
    o, cg, kh, kw = qw.shape
    (sh, sw), (ph, pw), (dh, dw) = stride, padding, dilation
    ho, wo = _out_size(h, kh, sh, ph, dh), _out_size(w, kw, sw, pw, dw)
    if groups == 1:
        xp = qx.new_zeros(n, h + 2 * ph, w + 2 * pw, c)
        xp[:, ph:ph + h, pw:pw + w] = qx.permute(0, 2, 3, 1)
        s = xp.stride()
        cols = xp.as_strided(
            (n, ho, wo, kh, kw, c),
            (s[0], sh * s[1], sw * s[2], dh * s[1], dw * s[2], s[3])
        ).reshape(n * ho * wo, kh * kw * c)
        wmat = qw.permute(0, 2, 3, 1).reshape(o, kh * kw * c)
        y = cuda_int_mm(cols, wmat)
        return y.view(n, ho, wo, o).permute(0, 3, 1, 2)
    launches['grouped'] += 1
    og = o // groups
    xp = qx.new_zeros(n, c, h + 2 * ph, w + 2 * pw, dtype=torch.int32)
    xp[:, :, ph:ph + h, pw:pw + w] = qx
    w32 = qw.to(torch.int32).view(groups, og, cg, kh, kw)
    out = torch.zeros(n, groups, og, ho, wo, dtype=torch.int32,
                      device=qx.device)
    for i in range(kh):
        for j in range(kw):
            tap = xp[:, :, i * dh:i * dh + sh * (ho - 1) + 1:sh,
                     j * dw:j * dw + sw * (wo - 1) + 1:sw]
            tap = tap.reshape(n, groups, cg, ho, wo)
            for ci in range(cg):
                out += tap[:, :, ci:ci + 1] * \
                    w32[:, :, ci, i, j].view(1, groups, og, 1, 1)
    return out.view(n, o, ho, wo)


def int_conv2d(qx, qw, stride, padding, dilation, groups):
    """The sums of an int8 conv: exact, float64 on the CPU, int32 on the
    card."""
    if qx.device.type == 'cuda':
        return cuda_int_conv2d(qx, qw, stride, padding, dilation, groups)
    if qx.device.type != 'cpu':
        raise RuntimeError(f'no int8 route on {qx.device}')
    return plain_int_conv2d(qx, qw, stride, padding, dilation, groups)


def int_linear(qx, qw):
    """The sums of an int8 Dense over the last axis of ``qx``: exact,
    float64 on the CPU, int32 on the card."""
    if qx.device.type == 'cuda':
        y = cuda_int_mm(qx.reshape(-1, qx.shape[-1]), qw)
        return y.reshape(*qx.shape[:-1], qw.shape[0])
    if qx.device.type != 'cpu':
        raise RuntimeError(f'no int8 route on {qx.device}')
    return plain_int_linear(qx, qw)


# ----------------------------------------------------------------------
# the layers under the contexts

def _channel_view(t, conv):
    return t.view(1, -1, 1, 1) if conv else t


def _int8_layer(conv, x, w, bias, geom, a_scale, static, path, observer):
    qx, a_s = quantize_activation(x, a_scale, static)
    qw, w_s = quantize_weight(w)
    y = int_conv2d(qx, qw, *geom) if conv else int_linear(qx, qw)
    if observer is not None:
        observer(path, conv, qx, qw, geom, y)
    out = y.float() * _channel_view(a_s * w_s, conv)
    if bias is not None:
        out = out + _channel_view(bias.float(), conv)
    return out.to(_out_dtype(x))


def _fake_quant(v, scale, static=False):
    """``v`` on the symmetric int8 grid ``scale`` wide, back in float, with
    a straight-through gradient: ``v + (q - v).detach()``."""
    v32 = v.float()
    q = torch.clamp(torch.round(_on_grid(v32, scale, static)), -127,
                    127) * scale
    return (v32 + (q - v32).detach()).to(v.dtype)


def _qat_layer(conv, x, w, bias, geom, a_scale, static, path, observer):
    del path, observer
    fx = _fake_quant(x, a_scale.float() / 127.0, static)
    dims = tuple(range(1, w.dim()))
    w_s = torch.clamp_min(w.detach().abs().amax(dim=dims), 1e-12) / 127.0
    fw = _fake_quant(w, w_s.view(-1, *([1] * (w.dim() - 1))))
    with torch.autocast(x.device.type, enabled=False):
        out = F.conv2d(fx.float(), fw.float(), None, *geom) if conv \
            else F.linear(fx.float(), fw.float())
    if bias is not None:
        out = out + _channel_view(bias, conv)
    return out.to(_out_dtype(x))


class _Intercept(TorchFunctionMode):
    """Calls ``layer(conv, x, w_rows, bias_rows, geometry, a_scale,
    static, path, observer)``
    for each block of every ``F.conv2d`` / ``F.linear`` whose weight a root
    names and ``skip`` does not, and concatenates the blocks' outputs on
    the channel axis; the rest run as they are. ``layer=None`` only
    records: ``record(path, x)`` a block, then the call runs unchanged."""

    def __init__(self, layer, scales, skip, observer=None, record=None):
        super().__init__()
        self.layer = layer
        self.scales = scales or {}
        self.skip = tuple(skip)
        self.index = _INDEX
        self.observer = observer
        self.record = record

    def _scale(self, path, x):
        """(activation scale, whether it is a calibrated constant)."""
        a = self.scales.get(path)
        if a is not None:
            return torch.tensor(float(a), dtype=torch.float32,
                                device=x.device), True
        return dynamic_scale(x), False

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        conv = func is F.conv2d
        if not (conv or func is F.linear):
            return func(*args, **kwargs)
        got = _conv_args(args, kwargs) if conv else _linear_args(args,
                                                                  kwargs)
        x, w, bias = got['input'], got['weight'], got['bias']
        blocks = self.index.lookup(w)
        if blocks is None:
            return func(*args, **kwargs)
        live = [b for b in blocks if not _should_skip(b[2], self.skip)]
        if self.layer is None:
            for _, _, path in live:
                self.record(path, x)
            return func(*args, **kwargs)
        if not live:
            return func(*args, **kwargs)
        geom = (got['stride'], got['padding'], got['dilation'],
                got['groups']) if conv else None
        outs = []
        for b0, b1, path in blocks:
            wb = w[b0:b1]
            bb = None if bias is None else bias[b0:b1]
            if _should_skip(path, self.skip):
                outs.append(F.conv2d(x, wb, bb, *geom) if conv
                            else F.linear(x, wb, bb))
                continue
            if conv and geom[3] > 1 and (b0, b1) != (0, w.shape[0]):
                raise NotImplementedError(f'{path}: a row block of a '
                                          f'grouped conv')
            outs.append(self.layer(conv, x, wb, bb, geom,
                                   *self._scale(path, x), path,
                                   self.observer))
        if len(outs) == 1:
            return outs[0]
        dtype = outs[0].dtype
        return torch.cat([o.to(dtype) for o in outs], dim=1 if conv else -1)


@contextlib.contextmanager
def int8_inference(act_scales: Optional[Dict[str, float]] = None,
                   skip: Iterable[str] = DEFAULT_SKIP,
                   observer: Optional[Callable] = None):
    """Context manager: every conv and Dense layer of the JAX layer set
    called inside runs int8 (int8 x int8 -> exact sums, rescaled in fp32);
    attention products, norms and the flash kernels are unchanged.

    ``act_scales``: ``{module_path: max|x|}`` from ``calibrate_act_scales``
    (or the JAX tool's JSON); a layer without an entry takes the dynamic
    ``max|x|`` of its input. ``skip``: fnmatch patterns of module paths
    left in float. ``observer(path, conv, qx, qw,
    geometry, sums)`` is called after each quantized product (the card
    check compares the route's sums with the plain version's there)."""
    with _Intercept(_int8_layer, act_scales, skip, observer):
        yield


@contextlib.contextmanager
def qat_training(act_scales: Optional[Dict[str, float]] = None,
                 skip: Iterable[str] = DEFAULT_SKIP):
    """Quantization-aware training: the same layers as ``int8_inference``
    run fake-quantized (the int8 program's grid, by conv linearity its
    forward) with straight-through gradients to the fp32 weights; the
    activation scale, calibrated or dynamic, carries no gradient."""
    with _Intercept(_qat_layer, act_scales, skip):
        yield


def qat_context_from_cfg(cfg):
    """``cfg.qat`` -> a context factory for the train step: ``True`` or
    ``dict(enabled=True, skip=..., act_scales=...)`` give
    ``qat_training``; otherwise ``contextlib.nullcontext``."""
    get = getattr(cfg, 'get', None)
    qat_cfg = get('qat') if callable(get) else None
    if not qat_cfg:
        return contextlib.nullcontext
    if qat_cfg is True:
        qat_cfg = {}
    kw = dict(act_scales=qat_cfg.get('act_scales'),
              skip=tuple(qat_cfg.get('skip', DEFAULT_SKIP)))
    if not qat_cfg.get('enabled', True):
        return contextlib.nullcontext
    return lambda: qat_training(**kw)


def percentile_abs(x, percentile: float) -> float:
    """``jnp.percentile(|x|, p)`` (linear interpolation) by a sort, which,
    unlike ``torch.quantile``, takes more than 2^24 elements."""
    v = x.detach().abs().float().flatten().sort().values
    pos = percentile / 100.0 * (v.numel() - 1)
    lo = int(pos // 1)
    hi = min(lo + 1, v.numel() - 1)
    frac = pos - lo
    return float(v[lo] * (1.0 - frac) + v[hi] * frac)


def calibrate_act_scales(apply_fn, batches,
                         skip: Iterable[str] = DEFAULT_SKIP,
                         percentile: float = 100.0) -> Dict[str, float]:
    """Run ``apply_fn(batch)`` over ``batches`` recording the running
    ``max|input|`` of every conv and Dense path (or, with ``percentile`` <
    100, the running max of each batch's percentile of ``|x|``); the table
    feeds ``int8_inference``, keyed as the JAX file's."""
    scales: Dict[str, float] = {}

    def record(path, x):
        stat = float(x.detach().abs().amax()) if percentile >= 100.0 \
            else percentile_abs(x, percentile)
        scales[path] = max(scales.get(path, 0.0), stat)

    with _Intercept(None, None, skip, record=record):
        for b in batches:
            apply_fn(b)
    return scales
