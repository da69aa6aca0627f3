"""Training API (port of ``pfst_tpu/apis/train.py``; mirrors
``rsiseg/apis/train.py:71-192``).

``build_algorithm`` gives the UDA algorithm when the config has ``uda``,
else a ``SupervisedTrainer`` around the segmentor; both have the
orchestrator API ``init_state`` / ``make_train_step``. ``train_segmentor``
is the explicit iteration loop in place of mmcv's ``IterBasedRunner``:
data, algorithm, optimizer, resume or warm start, then ``max_iters``
steps on one device with log, eval and checkpoint intervals. A prefetch
thread keeps two batches ahead, copied to the card on a side stream. The
hooks of ``log_config.hooks`` and ``custom_hooks`` (``core/hooks``) are
called as the JAX loop calls them (``train.py:529-552``): ``before_run``,
``after_train_iter`` every iteration before its checkpoint,
``after_eval`` after each evaluation and ``after_run`` at the end; a
hook's ``_StopTraining`` (the pseudo-labelling hooks') ends training, and
any other exception propagates. A hook type neither package registers is
skipped with a log line. With a ``WandbHookSeg``,
``PlotStatisticsHook`` or ``PlotMultiClassStatisticsHook`` among the
hooks, the step collects its visualisation states and every hook's
``after_train_iter`` gets them (``train.py:547-550``); else it gets
None.

With ``qat`` the whole step, forward and backward, runs under
``ops.quant.qat_context_from_cfg(cfg)()`` (``train.py:689-698``: the JAX
step is traced inside it, a teacher's forward included), and
``evaluation.quant_int8`` scores the int8 program (with
``evaluation.act_scales``) in the loop's evaluation (``:870-876``).

Under an initialized process group (``parallel.init_distributed``, the
tools' ``--launcher``) the loop is data-parallel, as the JAX loop is over
its ``data`` mesh (``train.py:416-456``): each rank trains on its device
with its ``rank::world`` shard of the loader, ``samples_per_gpu`` a rank;
the state starts (or resumes) as rank 0's; each step averages the
gradients, log vars and running statistics over the group
(``parallel.make_sharded_train_step``); a preemption stops every rank at
the same iteration, agreed on the log cadence (``train.py:755-770``);
evaluation runs through ``multi_gpu_test``; and only rank 0 writes
checkpoints, the log and the hooks' files.

``parallel.tp`` and ``parallel.zero`` (True or 1, 3; the two compose)
make the step a GSPMD one over the process group (``train.py:417-447,
554-596``): the ranks form a ``(data, model)`` layout
(``parallel.tp.get_2d_groups``), the loader shards by data index with
``samples_per_gpu`` a rank (the model ranks of a data index get the same
samples and seed their pipelines alike), the state is laid out after any
resume (``parallel.zero.attach``), every rank draws the single-process
step's random numbers (``step_generator(seed, it)``), checkpoints are
gathered whole, and evaluation scores a whole copy of the student.

Raising when a config asks for them: ``parallel.sp`` and ``spw``
(spatially sharded training, ROADMAP A14c-2); ``pp`` and ``ep``, which
are no loop modes (the JAX loop ignores them; ``parallel.pp.gpipe_apply``
and ``parallel.ep.moe_apply`` are the building blocks);
``data.decode_cache_mb`` (packs make decoding a one-time cost).
"""
from __future__ import annotations

import logging
import os
import os.path as osp
import queue
import random
import re
import signal
import threading
import time
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from ..core.checkpoint import (find_latest_checkpoint, load_checkpoint,
                               load_weights_into_state, restore_state,
                               save_checkpoint)
from ..core.hooks import HOOKS, _StopTraining, build_hook
from ..core.optimizers import build_optimizers
from ..datasets import build_dataloader, build_dataset
from ..datasets.pipelines import DeferNormalize
from ..models import build_train_model
from ..models.uda.pfgst import parse_losses
from ..models.uda.uda_decorator import UDATrainState, maybe_normalize_images
from ..ops.quant import qat_context_from_cfg
from ..parallel import (average_buffers, average_gradients,
                        average_log_vars, broadcast_state, default_group,
                        get_dist_info, make_sharded_train_step,
                        replicas_agree, sync_bn_group)
from ..utils.logger import get_root_logger, print_log
from ..utils.misc import resolve_device
from .test import multi_gpu_test, single_gpu_test


class SupervisedTrainer:
    """Source-only training with the UDA algorithms' orchestrator API
    (``EncoderDecoder.train_step``, reference ``encoder_decoder.py:127-
    164``). The state's ``teacher`` is None."""

    def __init__(self, model):
        self.model = model
        self.num_classes = model.num_classes
        self.device = next(model.parameters()).device

    def get_model(self):
        return self.model

    def init_state(self, generator: torch.Generator, tx) -> UDATrainState:
        """The segmentor's weights from the JAX package's initializers,
        drawn from ``generator`` on the CPU (so every device gets the same
        model), in train mode on the trainer's device; ``tx`` is a
        ``build_optimizer`` factory, bound to its parameters."""
        student = self.model.cpu().init_weights(generator)
        student.to(self.device).train()
        return UDATrainState(student=student, teacher=None,
                             optimizer=tx(student), step=0)

    def make_train_step(self, mean, std, collect_vis: bool = False,
                        group=None):
        """The train step ``(state, batch, generator) -> (state,
        log_vars)`` (``train.py:216-258``): ``forward_train`` losses,
        backward, optimizer step and ``step + 1``, in place on ``state``.
        With a process ``group``, one replica's step: ``SyncBN`` spans the
        group, and the gradients, the log vars and, after the optimizer
        step, the running statistics are averaged over it
        (``train.py:242-245``).
        ``batch`` holds ``img`` (NCHW, normalized, or uint8 / float16 on
        the 0-255 scale) and ``gt_semantic_seg`` on the state's device.
        The dropout of the step is seeded from ``generator``, drawn on the
        CPU. ``log_vars`` are 0-dim tensors on the device. With
        ``collect_vis`` the step returns ``(state, log_vars, {})``, as the
        JAX step does (``train.py:254``)."""

        def step_fn(state: UDATrainState, batch: dict,
                    generator: torch.Generator):
            batch = maybe_normalize_images(batch, mean, std)
            img = batch['img']
            seed = int(torch.randint(2**62, (), generator=generator))
            devices = [img.device] if img.device.type == 'cuda' else []
            state.student.train()
            with torch.random.fork_rng(devices=devices), \
                    sync_bn_group(group):
                torch.manual_seed(seed)
                losses, _ = state.student.forward_train(
                    img, batch['gt_semantic_seg'])
            total, log_vars = parse_losses(losses)
            state.optimizer.zero_grad()
            total.backward()
            average_gradients(state.optimizer.params, group)
            state.optimizer.step()
            average_buffers(state.student, group)
            state.step += 1
            log_vars = {k: v.detach() for k, v in log_vars.items()}
            log_vars['loss'] = total.detach()
            log_vars = average_log_vars(log_vars, group)
            return (state, log_vars, {}) if collect_vis else (state, log_vars)

        return step_fn


def build_algorithm(cfg, device: Union[str, torch.device] = 'cuda'):
    """UDA wrapper or supervised trainer, both orchestrator-shaped, on
    ``device`` (the card unless the CPU is asked for)."""
    model_or_algo = build_train_model(cfg, device=device)
    if hasattr(model_or_algo, 'make_train_step'):
        return model_or_algo
    return SupervisedTrainer(model_or_algo)


def init_random_seed(seed: Optional[int] = None) -> int:
    """(``apis/train.py:21-49``) ``seed``, or a random one."""
    if seed is not None:
        return seed
    return int(np.random.randint(2**31))


def set_random_seed(seed: int, deterministic: bool = False):
    """Seed ``random``, ``np.random`` (the pipelines' draws) and torch;
    ``deterministic`` also makes cuDNN deterministic."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    if deterministic:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False


def step_generator(seed: int, it: int, rank: int = 0) -> torch.Generator:
    """The generator of iteration ``it``'s random numbers on ``rank``, a
    function of the seed, the iteration and the rank (the JAX loop's
    ``fold_in(rng, it)`` and its step's ``fold_in(rng, axis_index)``), so
    a resumed run draws what the uninterrupted one does, each replica its
    own numbers, and rank 0 those of a single-process run. torch seeds
    its CPU generator with 32 bits, so the tuple is hashed into 32."""
    key = [seed, it] + ([rank] if rank else [])
    state = np.random.SeedSequence(key).generate_state(1)
    return torch.Generator().manual_seed(int(state[0]))


def _img_norm_from_pipeline(cfg) -> Dict[str, Any]:
    """The mean/std of the train pipeline's Normalize, DeferNormalize or
    ClipNormalize (the source's first, or ``MultiDomainDataset``'s first
    domain's, as the JAX file looks)."""
    train = cfg.data['train']
    first_domain = (train.get('datasets') or [None])[0]
    for node in (train.get('source'), first_domain, train):
        for t in (node or {}).get('pipeline') or []:
            if t.get('type') in ('Normalize', 'DeferNormalize',
                                 'ClipNormalize'):
                return dict(mean=list(t['mean']), std=list(t['std']))
    return dict(mean=[0.0, 0.0, 0.0], std=[1.0, 1.0, 1.0])


def _wire(opt) -> str:
    """The wire dtype of a ``device_normalize`` option: a dtype name, or
    'uint8' for True (one default for every such key; the JAX file gives
    the train key 'float16', ROADMAP C2)."""
    return opt if isinstance(opt, str) else 'uint8'


def apply_device_normalize(cfg):
    """``cfg.data.device_normalize`` (True, 'uint8' or 'float16'): every
    train-pipeline ``Normalize`` becomes ``DeferNormalize``, so images
    cross to the card on the 0-255 scale and the loop normalizes them
    there, putting each padded border back at 0 in normalized space
    (``_normalize_on_device``), as rsiseg's host Normalize-then-Pad does."""
    opt = cfg.data.get('device_normalize')
    if not opt:
        return cfg

    def walk(node):
        if isinstance(node, dict):
            for t in node.get('pipeline') or []:
                if t.get('type') == 'Normalize':
                    t['type'] = 'DeferNormalize'
                    t['wire_dtype'] = _wire(opt)
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)

    walk(cfg.data['train'])
    return cfg


# the JAX loop's ``cfg.parallel`` modes: the GSPMD ones the port runs,
# spatially sharded training, which waits, and the building blocks the
# JAX loop does not read
LOOP_PARALLEL = ('tp', 'zero')
WAITING_PARALLEL = ('sp', 'spw')
BLOCK_PARALLEL = ('pp', 'ep')


def _refuse_waiting(cfg):
    """Raise for what the config asks of the JAX loop that the port does
    not do yet, and for ``pp`` / ``ep``, which are no loop modes: nothing
    is skipped silently."""
    par = {k: v for k, v in (cfg.get('parallel') or {}).items()
           if v not in (None, 0, 1, False)}
    waiting = {k: v for k, v in par.items() if k in WAITING_PARALLEL}
    if waiting:
        raise NotImplementedError(f'parallel {waiting}: spatially sharded '
                                  f'training is not ported (ROADMAP '
                                  f'A14c-2)')
    blocks = {k: v for k, v in par.items() if k in BLOCK_PARALLEL}
    if blocks:
        raise NotImplementedError(
            f'parallel {blocks} is not a mode of the train loop (the JAX '
            f'loop reads only tp, zero, sp and spw): pipeline and expert '
            f'parallelism are the building blocks '
            f'parallel.pp.gpipe_apply and parallel.ep.moe_apply')
    unknown = set(par) - set(LOOP_PARALLEL + WAITING_PARALLEL +
                             BLOCK_PARALLEL)
    if unknown:
        raise ValueError(f'unknown parallel options {sorted(unknown)}')
    if cfg.data.get('decode_cache_mb'):
        raise NotImplementedError('data.decode_cache_mb is not ported: '
                                  'pack the dataset instead '
                                  '(tools/pack_dataset_torch.py)')


def _hook_cfgs(cfg) -> List[dict]:
    return [dict(h) for h in
            list((cfg.get('log_config') or {}).get('hooks') or [])
            + list(cfg.get('custom_hooks') or [])]


def build_hooks(cfg, logger=None) -> list:
    """The hooks of ``log_config.hooks`` and ``custom_hooks``, in that
    order (reference ``apis/train.py:138-182``); a type that is not
    registered is skipped with a log line, as the JAX loop does."""
    hooks = []
    for hc in _hook_cfgs(cfg):
        if hc.get('type') not in HOOKS:
            print_log(f'skipping unknown hook {hc}', logger)
            continue
        hooks.append(build_hook(hc))
    return hooks


# the hooks that read the step's visualisation states, by class name
# (``train.py:547-550``)
VIS_HOOKS = ('WandbHookSeg', 'PlotStatisticsHook',
             'PlotMultiClassStatisticsHook')


class DeviceBatch:
    """A batch on its way to the device: its tensors, the event its
    copies end with (None on the CPU), its metas and dataset indices."""

    def __init__(self, tensors, ready, metas, indices):
        self.tensors = tensors
        self.ready = ready
        self.metas = metas
        self.indices = indices

    def wait(self) -> Dict[str, torch.Tensor]:
        """The tensors, usable on the current stream."""
        if self.ready is not None:
            stream = torch.cuda.current_stream()
            stream.wait_event(self.ready)
            for t in self.tensors.values():
                t.record_stream(stream)
        return self.tensors


def make_to_device(device: torch.device, compress_gt: bool):
    """``batch -> DeviceBatch``. On the card the copies are non-blocking
    from the loader's pinned memory, on a side stream of their own, so
    they overlap the step; label maps cross as uint8 when
    ``compress_gt`` (the ignore index 255 and up to 255 classes fit)."""
    stream = torch.cuda.Stream(device) if device.type == 'cuda' else None

    def to_device(batch) -> DeviceBatch:
        host = {}
        for k, v in batch.items():
            if not isinstance(v, torch.Tensor) or k == 'indices':
                continue
            if compress_gt and 'seg' in k and \
                    v.dtype in (torch.int32, torch.int64):
                v = torch.empty(v.shape, dtype=torch.uint8,
                                pin_memory=v.is_pinned()).copy_(v)
            host[k] = v
        metas = {k: v for k, v in batch.items() if k.endswith('img_metas')}
        if stream is None:
            return DeviceBatch(host, None, metas, batch.get('indices'))
        with torch.cuda.stream(stream):
            out = {k: v.to(device, non_blocking=True)
                   for k, v in host.items()}
            ready = torch.cuda.Event()
            ready.record(stream)
        return DeviceBatch(out, ready, metas, batch.get('indices'))

    return to_device


def _metas_key(key: str) -> str:
    """The metas of an image key: ``target_img_metas`` for ``target_*``,
    ``dom{i}_img_metas`` for ``dom{i}_*`` (``MultiDomainDataset``),
    ``img_metas`` else (``train.py:258-276``)."""
    m = re.match(r'(target_|dom\d+_)', key)
    return f'{m.group(1)}img_metas' if m else 'img_metas'


def _normalize_on_device(tensors, metas, mean, std):
    """Normalize images that crossed on the 0-255 scale
    (``maybe_normalize_images``) and put their padded borders at 0 in
    normalized space, where rsiseg's Normalize-then-Pad leaves them: a
    sample's image holds ``img_shape`` rows and columns of content at
    its top left (``Pad`` pads the bottom and right)."""
    out = maybe_normalize_images(tensors, mean, std)
    for key, t in out.items():
        if 'img' not in key or tensors[key].dtype == torch.float32:
            continue
        key_metas = metas.get(_metas_key(key)) or []
        for i, meta in enumerate(key_metas):
            h, w = meta['img_shape'][:2]
            if h < t.shape[2]:
                t[i, :, h:] = 0
            if w < t.shape[3]:
                t[i, :, :, w:] = 0
    return out


class BatchPrefetcher:
    """A thread that keeps ``depth`` batches ahead of the loop: it pulls
    them from the loader (whose workers run the pipelines) and starts
    their copies to the device (``make_to_device``), so both overlap the
    step. The reference gets the same overlap from torch DataLoader
    workers. An error in the thread is raised in the loop."""

    _ERR = object()

    def __init__(self, batch_iter, to_device, depth: int = 2):
        self._iter = batch_iter
        self._to_device = to_device
        self._q: 'queue.Queue' = queue.Queue(maxsize=max(depth, 1))
        self._err = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        name='pfst-prefetch', daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            try:
                item = self._to_device(next(self._iter))
            except BaseException as e:  # noqa: BLE001 - raised in next()
                self._err = e
                item = self._ERR
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.5)
                    break
                except queue.Full:
                    continue
            if item is self._ERR:
                return

    def next(self) -> DeviceBatch:
        item = self._q.get()
        if item is self._ERR:
            raise self._err
        return item

    def close(self):
        """Stop the thread, then close the loader's iterator (which stops
        its producer)."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=60.0)
        if not self._thread.is_alive():
            self._iter.close()


def _log_line(it, max_iters, dt, data, log_vars):
    msg = ', '.join(f'{k}: {v:.4f}' for k, v in sorted(log_vars.items()))
    return (f'Iter [{it}/{max_iters}] time: {dt:.3f}s data: {data:.3f}s  '
            f'{msg}')


def train_segmentor(cfg,
                    work_dir: Optional[str] = None,
                    resume_from: Optional[str] = None,
                    load_from: Optional[str] = None,
                    auto_resume: bool = False,
                    validate: bool = True,
                    seed: int = 0,
                    meta: Optional[Dict] = None,
                    max_iters_override: Optional[int] = None,
                    device: Union[str, torch.device] = 'cuda',
                    history: Optional[List[dict]] = None):
    """The train loop (``train.py:392-837``).

    Runs on ``device`` (the card unless the CPU is asked for; under a
    process group, this rank's device). Iteration ``it`` draws its random
    numbers from ``step_generator(seed, it, rank)``; the pipelines draw
    from ``np.random``, seeded here with ``seed + rank``. With ``history``
    given, the loop appends a record of each event to it: ``{'kind':
    'batch', 'iter', 'indices'}`` for each batch taken, ``'log'`` (``iter``,
    ``time`` and ``data`` in s/iter over the interval, ``log_vars``),
    ``'eval'`` (``iter``, ``metrics``), ``'checkpoint'`` (``iter``,
    ``path``) and ``'halt'`` (``iter``: a hook ended training after it).
    Returns the train state."""
    device = resolve_device(device)
    group = default_group()
    rank, world = get_dist_info()
    if work_dir and rank == 0:
        os.makedirs(work_dir, exist_ok=True)
    logger = get_root_logger(
        osp.join(work_dir, 'train.log') if work_dir else None)
    _refuse_waiting(cfg)
    layout, zero_level = _gspmd_layout(cfg, group)
    # the pipelines' draws: a model rank's samples are its data index's
    data_index = layout.data_index if layout is not None else rank
    set_random_seed(seed + data_index)
    apply_device_normalize(cfg)

    train_ds = build_dataset(cfg.data['train'])
    loader = build_dataloader(
        train_ds, cfg.data.get('samples_per_gpu', 2),
        cfg.data.get('workers_per_gpu', 2),
        dist=group is not None and layout is None,
        shuffle=True, seed=seed, drop_last=True, infinite=True,
        pin_memory=device.type == 'cuda',
        rank=data_index, world_size=layout.n_data if layout else 1,
        use_processes=cfg.data.get('use_processes', False))
    max_iters = max_iters_override or cfg.runner['max_iters']
    algo = build_algorithm(cfg, device=device)
    opt_cfg = dict(cfg.get('optimizer_config') or {})
    # a dict of optimizer configs (no 'type': DomainAdaptorAdv's generator
    # and discriminator) gives a dict of factories, which the algorithm's
    # init_state reads (``train.py:456-470``)
    tx = build_optimizers(dict(cfg.optimizer), cfg.get('lr_config'),
                          max_iters, opt_cfg.get('grad_clip'),
                          opt_cfg.get('cumulative_iters', 1),
                          opt_cfg.get('skip_nonfinite', 0))
    norm = _img_norm_from_pipeline(cfg)
    print_log('initializing model state...', logger)
    state = algo.init_state(torch.Generator().manual_seed(seed), tx)

    start_iter = 0
    if resume_from is None and auto_resume:
        resume_from = find_latest_checkpoint(work_dir)
    if resume_from:
        state = restore_state(state, load_checkpoint(resume_from))
        start_iter = state.step
        print_log(f'resumed from {resume_from} @ iter {start_iter}', logger)
        # the seeded stream at the batch this iteration takes in an
        # uninterrupted run (the reference replays each epoch from its
        # start)
        loader.set_position(start_iter)
    else:
        load_from = load_from or cfg.get('load_from')
        if not load_from:
            p = (cfg.model or {}).get('pretrained')
            if isinstance(p, str) and osp.exists(osp.expanduser(p)):
                load_from = p
        if load_from:
            state = load_weights_into_state(state, load_checkpoint(load_from),
                                            logger)
            print_log(f'loaded weights from {load_from} (optimizer/step '
                      f'fresh)', logger)
    broadcast_state(state, group)
    if layout is not None:
        # ZeRO and tensor parallelism: the whole state laid out over the
        # ranks (a resumed one included), the step a GSPMD one
        from ..parallel import zero
        state = zero.attach(state, layout, zero_level)

    log_interval = (cfg.get('log_config') or {}).get('interval', 50)
    ckpt_interval = (cfg.get('checkpoint_config') or {}).get('interval',
                                                             4000)
    eval_cfg = cfg.get('evaluation') or {}
    eval_interval = eval_cfg.get('interval', 4000)
    # the writers act on rank 0; a hook that every rank must run (one
    # that halts training) says so with ``all_ranks``
    hooks = [h for h in build_hooks(cfg, logger)
             if rank == 0 or getattr(h, 'all_ranks', False)]
    collect_vis = any(type(h).__name__ in VIS_HOOKS for h in hooks)
    if layout is not None:
        from ..parallel import zero
        step_fn = zero.make_global_step(algo, norm['mean'], norm['std'],
                                        state.sharding, collect_vis)
    elif group is None:
        step_fn = algo.make_train_step(norm['mean'], norm['std'],
                                       collect_vis=collect_vis)
    else:
        step_fn = make_sharded_train_step(algo, norm['mean'], norm['std'],
                                          group, collect_vis=collect_vis)
    # a GSPMD step draws the single-process step's numbers on every rank
    gen_rank = 0 if layout is not None else rank
    ctx = {'work_dir': work_dir, 'iter': start_iter, 'algo': algo,
           'palette': getattr(train_ds, 'PALETTE', None),
           'source_dataset': getattr(train_ds, 'source', train_ds),
           'cfg': cfg, 'state': state}
    for h in hooks:
        h.before_run(ctx)
    qat_ctx = qat_context_from_cfg(cfg)
    compress_gt = bool(cfg.data.get('device_normalize'))
    prefetcher = BatchPrefetcher(iter(loader),
                                 make_to_device(device, compress_gt))

    # preemption: SIGTERM / SIGUSR1 ask for a checkpoint and a clean exit
    # at the next iteration boundary (handlers install only in the main
    # thread)
    preempt = {'sig': None, 'vote': False}
    old_handlers = {}
    if work_dir and threading.current_thread() is threading.main_thread():
        def on_preempt(sig, frame):
            preempt['sig'] = sig

        for s in (signal.SIGTERM, signal.SIGUSR1):
            old_handlers[s] = signal.signal(s, on_preempt)

    def record(kind, **fields):
        if history is not None:
            history.append(dict(kind=kind, **fields))

    def checkpoint(it):
        path = save_checkpoint(work_dir, it, state, meta=meta)
        record('checkpoint', iter=it, path=path)
        print_log(f'checkpoint saved @ iter {it}: {path}', logger)

    print_log('entering train loop', logger)
    val = None
    halted = False
    t_data = 0.0
    t_last = time.time()
    try:
        for it in range(start_iter, max_iters):
            t0 = time.time()
            batch = prefetcher.next()
            t_data += time.time() - t0
            record('batch', iter=it + 1, indices=batch.indices.tolist())
            tensors = _normalize_on_device(batch.wait(), batch.metas,
                                           norm['mean'], norm['std'])
            with qat_ctx():
                out = step_fn(state, tensors,
                              step_generator(seed, it, gen_rank))
            state, log_vars = out[:2]
            vis_states = out[2] if collect_vis else None
            if (it + 1) % log_interval == 0:
                # read the log vars (which waits for the card) before the
                # clock, so the wait belongs to this window
                names = list(log_vars)
                values = torch.stack([log_vars[k].float()
                                      for k in names]).cpu().tolist()
                host_vars = dict(zip(names, values))
                dt = (time.time() - t_last) / log_interval
                data = t_data / log_interval
                print_log(_log_line(it + 1, max_iters, dt, data, host_vars),
                          logger)
                record('log', iter=it + 1, time=dt, data=data,
                       log_vars=host_vars)
                t_last, t_data = time.time(), 0.0
                bad = [k for k, v in host_vars.items()
                       if not np.isfinite(v)]
                if bad:
                    print_log(f'NON-FINITE loss values at iter {it + 1}: '
                              f'{bad}', logger, level=logging.WARNING)
            # every iteration, before its checkpoint (hooks gate on their
            # own intervals)
            ctx['iter'], ctx['state'] = it + 1, state
            try:
                for h in hooks:
                    h.after_train_iter(ctx, log_vars, vis_states)
            except _StopTraining as e:
                print_log(f'training halted by hook: {e}', logger)
                record('halt', iter=it + 1)
                halted = True
                break
            stop = preempt['sig'] is not None
            if group is not None:
                # the ranks agree on the stop iteration: a vote on the log
                # cadence (``train.py:755-770``)
                stop = work_dir is not None and \
                    (it + 1) % log_interval == 0 and \
                    replicas_agree(stop, group)
            if work_dir and stop:
                preempt['vote'] = True
                checkpoint(it + 1)
                print_log(f'preemption signal '
                          f'{preempt["sig"] or "(peer vote)"}: exiting '
                          f'(auto_resume continues from here)', logger)
                break
            if work_dir and (it + 1) % ckpt_interval == 0:
                checkpoint(it + 1)
            if validate and (it + 1) % eval_interval == 0:
                if val is None:
                    val = _build_val(cfg)
                metrics = evaluate_during_train(val, state, eval_cfg,
                                                logger)
                record('eval', iter=it + 1, metrics=metrics)
                for h in hooks:
                    h.after_eval(ctx, metrics or {})
                save_best = eval_cfg.get('save_best')
                if work_dir and save_best and save_best in metrics and \
                        metrics[save_best] > val['best']:
                    val['best'] = metrics[save_best]
                    save_checkpoint(osp.join(work_dir, 'best'), it + 1,
                                    state, meta=meta)
                    print_log(f'new best {save_best}='
                              f'{metrics[save_best]:.4f} @ iter {it + 1}',
                              logger)
    finally:
        prefetcher.close()
        loader.close()
        for s, h in old_handlers.items():
            signal.signal(s, h)
    # the ranks of a group skip the last checkpoint together
    preempted = preempt['vote'] if group is not None \
        else preempt['sig'] is not None
    if work_dir and not preempted and \
            (state.step % ckpt_interval != 0 or halted):
        # a halted iteration's own checkpoint did not run
        checkpoint(state.step)
    for h in hooks:
        h.after_run(ctx)
    return state


def _gspmd_layout(cfg, group):
    """(the ranks' layout, the ZeRO level) of ``cfg.parallel``'s ``tp``
    and ``zero`` (``train.py:417-447``), (None, 0) for neither. ``zero``
    True or 1 is ZeRO-1, 3 ZeRO-3; without a process group ZeRO is off,
    as the JAX loop leaves it off on one device."""
    par = cfg.get('parallel') or {}
    tp_size = int(par.get('tp') or 1)
    zero_level = int(par.get('zero') or 0)
    zero_level = 0 if zero_level <= 0 else (3 if zero_level >= 3 else 1)
    if tp_size <= 1 and (not zero_level or group is None):
        return None, 0
    if group is None:
        raise AssertionError(f'1 device not divisible by parallel.tp='
                             f'{tp_size}: launch tp ranks (--launcher)')
    from ..parallel import tp, zero
    layout = tp.get_2d_groups(tp_size, group) if tp_size > 1 \
        else zero.get_data_layout(group)
    return layout, zero_level


def _build_val(cfg) -> dict:
    """The validation dataset (test mode) and its loader, built once a
    run; ``data.device_normalize_eval`` narrows its wire as
    ``device_normalize`` does the train pipeline's."""
    val_cfg = {**cfg.data['val'], 'test_mode': True}
    wire = cfg.data.get('device_normalize_eval')
    if wire:
        import copy
        val_cfg = copy.deepcopy(val_cfg)
        DeferNormalize.swap_into(val_cfg.get('pipeline'), _wire(wire))
    dataset = build_dataset(val_cfg)
    return dict(dataset=dataset,
                loader=build_dataloader(dataset, 1, 1, shuffle=False),
                best=-1.0)


@torch.no_grad()
def evaluate_during_train(val: dict, state, eval_cfg: dict, logger=None):
    """The student on the validation set, in eval mode, whole image by
    whole image (the EvalHook, ``eval_hooks.py:45-133``), as int8 with
    ``eval_cfg``'s ``quant_int8`` (and ``act_scales``); returns the
    dataset's ``evaluate`` metrics. Under a process group of more than
    one rank each rank scores its share through ``multi_gpu_test``
    (``train.py:876-882``), and every rank gets every metric."""
    student = state.student
    if getattr(state, 'sharding', None) is not None:
        # a ZeRO or tensor-parallel student: score a whole copy
        from ..parallel import zero
        student = zero.whole_copy(state)
    was_training = student.training
    student.eval()
    test_fn = multi_gpu_test if get_dist_info()[1] > 1 else single_gpu_test
    try:
        results = test_fn(
            student, val['loader'], pre_eval=True,
            quant_int8=bool(eval_cfg.get('quant_int8')),
            act_scales=eval_cfg.get('act_scales'))
    finally:
        student.train(was_training)
    return val['dataset'].evaluate(results,
                                   metric=eval_cfg.get('metric', 'mIoU'),
                                   logger=logger)
