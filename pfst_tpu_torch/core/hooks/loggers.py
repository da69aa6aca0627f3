"""Logger hooks (port of ``pfst_tpu/core/hooks/loggers.py``).

* ``TextLoggerHook`` is a no-op: the train loop writes its log line
  itself.
* ``TensorboardLoggerHook`` writes the log vars as scalars every
  ``interval`` iterations to one TensorBoard event file a run, under
  ``log_dir`` or ``{work_dir}/tb``, with the port's own writer
  (``tb_events.py``; the JAX file writes through ``tf.summary``).
* ``WandbHookSeg`` (rsiseg ``wandblogger_hook_seg.py:27``) logs the
  scalars and the step's ``vis|`` states (seg-mask triplets, similarity
  density maps, histograms) to W&B every ``interval`` iterations; the
  states are copied to the host only then, ``num_vis`` samples of each.
  Without ``wandb`` it warns and logs nothing, as the JAX hook does; the
  loop still collects the states. ``MMSegWandbHook`` logs the scalars
  only, ``WandbHookStatistics`` is the same hook.
* ``ProfilerHook`` traces the iterations after ``start_iter`` for
  ``num_steps`` iterations with ``torch.profiler`` (the JAX file's
  ``jax.profiler`` trace) and writes a Chrome trace under
  ``{work_dir}/{out_dir}``.

The step's states are in the port's NCHW layout; the W&B hook turns each
4-D one into the JAX step's NHWC before it builds images, so its payload
is the JAX hook's.
"""
from __future__ import annotations

import json
import os
import os.path as osp

import numpy as np
import torch

from ...utils.logger import get_root_logger
from .hook import HOOKS, Hook
from .tb_events import EventFileWriter


def host_scalars(log_vars) -> dict:
    """The log vars (0-dim tensors on one device) as Python floats, with
    one copy from the device."""
    names = list(log_vars)
    if not names:
        return {}
    values = torch.stack([log_vars[k].float() for k in names]).cpu()
    return dict(zip(names, values.tolist()))


@HOOKS.register_module()
class TextLoggerHook(Hook):

    def __init__(self, by_epoch=False, interval=50, **kwargs):
        self.interval = interval


@HOOKS.register_module()
class TensorboardLoggerHook(Hook):

    def __init__(self, log_dir=None, interval=50, **kwargs):
        self.log_dir = log_dir
        self.interval = interval
        self.writer = None

    def before_run(self, ctx):
        self.writer = EventFileWriter(
            self.log_dir or (ctx.get('work_dir') or '.') + '/tb')

    def after_train_iter(self, ctx, log_vars, vis_states=None):
        step = ctx['iter']
        if self.writer is None or step % self.interval:
            return
        self.writer.add_scalars(step, host_scalars(log_vars))

    def after_run(self, ctx):
        if self.writer is not None:
            self.writer.close()


def _colorize(label, palette):
    label = np.asarray(label).astype(np.int64)
    pal = np.asarray(palette, np.uint8)
    out = np.zeros(label.shape + (3,), np.uint8)
    valid = (label >= 0) & (label < len(pal))
    out[valid] = pal[label[valid]]
    return out


def _norm_img(img):
    img = np.asarray(img, np.float32)
    lo, hi = img.min(), img.max()
    return ((img - lo) / max(hi - lo, 1e-6) * 255).astype(np.uint8)


def to_jax_layout(value, n=None):
    """A vis state part on the host, the first ``n`` samples: a tensor's
    4-D NCHW becomes the JAX step's NHWC; other values pass through
    ``np.asarray``."""
    if isinstance(value, torch.Tensor):
        value = value.detach()[:n] if n is not None else value.detach()
        if value.dim() == 4:
            value = value.permute(0, 2, 3, 1)
        return value.cpu().numpy()
    value = np.asarray(value)
    return value[:n] if n is not None else value


@HOOKS.register_module()
class WandbHookSeg(Hook):
    """W&B logging of scalars and ``vis|`` visualisation states
    (``wandblogger_hook_seg.py:134-287``). A seg-mask triplet whose image
    and label maps differ in height (the PFGST step's head-resolution
    predictions beside its full-resolution images) cannot be put side by
    side; the JAX hook's concatenation fails and it skips the entry, and
    so does this one, with a warning the first time."""

    def __init__(self, init_kwargs=None, interval=200, num_vis=2,
                 **kwargs):
        self.init_kwargs = init_kwargs or {}
        self.interval = interval
        self.num_vis = num_vis
        self._wandb = None
        self._skipped = set()

    def before_run(self, ctx):
        logger = get_root_logger()
        try:
            import wandb
        except ImportError as e:
            logger.warning(f'wandb unavailable: {e}')
            return
        try:
            wandb.init(**self.init_kwargs)
        except Exception as e:  # noqa: BLE001 - logging must not end a run
            logger.warning(f'wandb unavailable: {e!r}')
            return
        self._wandb = wandb

    def _triplet(self, name, value, palette, i):
        img, gt, pred = value
        parts = [_norm_img(img[i]), _colorize(np.squeeze(gt[i]), palette),
                 _colorize(np.squeeze(pred[i]), palette)]
        if any(p.ndim != 3 or p.shape[0] != parts[0].shape[0] or
               p.shape[2] != parts[0].shape[2] for p in parts):
            if name not in self._skipped:
                self._skipped.add(name)
                get_root_logger().warning(
                    f'{name}: image and label maps of shapes '
                    f'{[p.shape for p in parts]} cannot be put side by '
                    f'side; not logged')
            return None
        return np.concatenate(parts, axis=1)

    def vis_payload(self, vis_states, palette) -> dict:
        """The images and histograms of ``vis_states``, by W&B key."""
        payload = {}
        for name, value in (vis_states or {}).items():
            kind = name.split('|')[1] if '|' in name else name
            if kind.startswith('seg_mask') and palette is not None:
                parts = [to_jax_layout(v, self.num_vis) for v in value]
                for i in range(min(self.num_vis, parts[0].shape[0])):
                    trip = self._triplet(name, parts, palette, i)
                    if trip is None:
                        break
                    payload[f'{name}/{i}'] = self._wandb.Image(trip)
            elif kind.startswith('density'):
                img, density = [to_jax_layout(v, self.num_vis)
                                for v in value[:2]]
                for i in range(min(self.num_vis, img.shape[0])):
                    payload[f'{name}/{i}'] = self._wandb.Image(
                        np.squeeze(density[i]))
            elif kind.startswith('hist'):
                names, values = value
                for nm, vals in zip(names, values):
                    payload[f'{name}/{nm}'] = \
                        self._wandb.Histogram(to_jax_layout(vals))
        return payload

    def after_train_iter(self, ctx, log_vars, vis_states=None):
        if self._wandb is None or ctx['iter'] % self.interval:
            return
        payload = host_scalars(log_vars)
        payload.update(self.vis_payload(vis_states, ctx.get('palette')))
        self._wandb.log(payload, step=ctx['iter'])

    def after_run(self, ctx):
        if self._wandb is not None:
            self._wandb.finish()


@HOOKS.register_module()
class MMSegWandbHook(WandbHookSeg):
    """Scalar-only W&B hook (``wandblogger_hook.py``)."""

    def after_train_iter(self, ctx, log_vars, vis_states=None):
        super().after_train_iter(ctx, log_vars, None)


@HOOKS.register_module()
class WandbHookStatistics(WandbHookSeg):
    """The statistics variant, kept for config compatibility."""


def _student_device(ctx) -> torch.device:
    state = ctx.get('state')
    student = getattr(state, 'student', None)
    if student is None:
        return torch.device('cpu')
    return next(student.parameters()).device


@HOOKS.register_module()
class ProfilerHook(Hook):
    """A ``torch.profiler`` trace of the iterations after ``start_iter``,
    ``num_steps`` of them (the JAX file's steps [start_iter, start_iter +
    num_steps)), written as a Chrome trace to
    ``{work_dir}/{out_dir}/trace_iter_<first>-<last>.json``. Its
    activities are the CPU and, when the student is on the card, CUDA;
    there the card is synchronized at both ends of the window, so the
    trace holds whole iterations, and a trace without CUDA kernel events
    raises instead of passing for the card's.

    Usage::

        custom_hooks = [dict(type='ProfilerHook', start_iter=10,
                             num_steps=5)]
    """

    def __init__(self, start_iter=10, num_steps=5, out_dir='profile',
                 **kwargs):
        self.start_iter = int(start_iter)
        self.num_steps = int(num_steps)
        self.out_dir = out_dir
        self._prof = None
        self._cuda = False
        self._dir = None
        self.path = None

    def after_train_iter(self, ctx, log_vars, vis_states=None):
        it = int(ctx.get('iter', 0))
        if self._prof is None and it == self.start_iter:
            self._start(ctx)
        elif self._prof is not None and \
                it >= self.start_iter + self.num_steps:
            self._stop(it)

    def _start(self, ctx):
        from torch.profiler import ProfilerActivity, profile
        self._cuda = _student_device(ctx).type == 'cuda'
        activities = [ProfilerActivity.CPU]
        if self._cuda:
            activities.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self._dir = osp.join(ctx.get('work_dir') or '.', self.out_dir)
        self._prof = profile(activities=activities)
        self._prof.start()
        get_root_logger().info(f'profiler trace started -> {self._dir}')

    def _stop(self, it):
        if self._cuda:
            torch.cuda.synchronize()
        prof, self._prof = self._prof, None
        prof.stop()
        os.makedirs(self._dir, exist_ok=True)
        self.path = osp.join(self._dir, f'trace_iter_{self.start_iter + 1}'
                             f'-{it}.json')
        prof.export_chrome_trace(self.path)
        get_root_logger().info(f'profiler trace stopped: {self.path}')
        if self._cuda and not trace_kernels(self.path):
            raise RuntimeError(f'{self.path}: the trace holds no CUDA kernel '
                               f'event; the profiler did not trace the card')

    def after_run(self, ctx):
        if self._prof is not None:
            self._stop(int(ctx.get('iter', 0)))


def trace_kernels(path: str) -> list:
    """The CUDA kernel events (``cat`` 'kernel') of a Chrome trace."""
    with open(path) as f:
        trace = json.load(f)
    events = trace['traceEvents'] if isinstance(trace, dict) else trace
    return [e for e in events if e.get('cat') == 'kernel']
