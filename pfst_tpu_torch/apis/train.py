"""Training API (port of ``pfst_tpu/apis/train.py``; mirrors
``rsiseg/apis/train.py:71-192``).

``build_algorithm`` gives the UDA algorithm when the config has ``uda``,
else a ``SupervisedTrainer`` around the segmentor; both have the
orchestrator API ``init_state`` / ``make_train_step``. ``train_segmentor``
is the explicit iteration loop in place of mmcv's ``IterBasedRunner``:
data, algorithm, optimizer, resume or warm start, then ``max_iters``
steps on one device with log, eval and checkpoint intervals. A prefetch
thread keeps two batches ahead, copied to the card on a side stream.

Waiting, and raising ``NotImplementedError`` when a config asks for them:
``parallel.*`` (tensor, spatial, ZeRO) and ``qat`` (ROADMAP A14); hooks
other than ``TextLoggerHook``, whose log line is the loop's own (A12);
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
from ..core.optimizers import build_optimizers
from ..datasets import build_dataloader, build_dataset
from ..datasets.pipelines import DeferNormalize
from ..models import build_train_model
from ..models.uda.pfgst import parse_losses
from ..models.uda.uda_decorator import UDATrainState, maybe_normalize_images
from ..utils.logger import get_root_logger, print_log
from ..utils.misc import resolve_device
from .test import single_gpu_test


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

    def make_train_step(self, mean, std, collect_vis: bool = False):
        """The train step ``(state, batch, generator) -> (state,
        log_vars)`` (``train.py:216-258``): ``forward_train`` losses,
        backward, optimizer step and ``step + 1``, in place on ``state``.
        ``batch`` holds ``img`` (NCHW, normalized, or uint8 / float16 on
        the 0-255 scale) and ``gt_semantic_seg`` on the state's device.
        The dropout of the step is seeded from ``generator``, drawn on the
        CPU. ``log_vars`` are 0-dim tensors on the device."""
        if collect_vis:
            raise NotImplementedError('collect_vis is not ported')

        def step_fn(state: UDATrainState, batch: dict,
                    generator: torch.Generator):
            batch = maybe_normalize_images(batch, mean, std)
            img = batch['img']
            seed = int(torch.randint(2**62, (), generator=generator))
            devices = [img.device] if img.device.type == 'cuda' else []
            state.student.train()
            with torch.random.fork_rng(devices=devices):
                torch.manual_seed(seed)
                losses, _ = state.student.forward_train(
                    img, batch['gt_semantic_seg'])
            total, log_vars = parse_losses(losses)
            state.optimizer.zero_grad()
            total.backward()
            state.optimizer.step()
            state.step += 1
            log_vars = {k: v.detach() for k, v in log_vars.items()}
            log_vars['loss'] = total.detach()
            return state, log_vars

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


def step_generator(seed: int, it: int) -> torch.Generator:
    """The generator of iteration ``it``'s random numbers, a function of
    the seed and the iteration (the JAX loop's ``fold_in(rng, it)``), so a
    resumed run draws what the uninterrupted one does. torch seeds its
    CPU generator with 32 bits, so the pair is hashed into 32."""
    state = np.random.SeedSequence([seed, it]).generate_state(1)
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


def _refuse_waiting(cfg):
    """Raise for what the config asks of the JAX loop that the port does
    not do yet; nothing is skipped silently."""
    par = {k: v for k, v in (cfg.get('parallel') or {}).items()
           if v not in (None, 0, 1, False)}
    if par:
        raise NotImplementedError(f'parallel {par} is not ported (ROADMAP '
                                  f'A14)')
    if cfg.get('qat') or (cfg.get('evaluation') or {}).get('quant_int8'):
        raise NotImplementedError('quantization (qat, quant_int8) is not '
                                  'ported (ROADMAP A14)')
    hooks = [dict(h).get('type') for h in
             (cfg.get('log_config') or {}).get('hooks') or []]
    hooks += [dict(h).get('type') for h in cfg.get('custom_hooks') or []]
    others = [h for h in hooks if h != 'TextLoggerHook']
    if others:
        raise NotImplementedError(f'hooks {others} are not ported '
                                  f'(ROADMAP A12)')
    if cfg.data.get('decode_cache_mb'):
        raise NotImplementedError('data.decode_cache_mb is not ported: '
                                  'pack the dataset instead '
                                  '(tools/pack_dataset_torch.py)')


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
    """The train loop (``train.py:392-837``, its single-device branch).

    Runs on ``device`` (the card unless the CPU is asked for). Iteration
    ``it`` draws its random numbers from ``step_generator(seed, it)``;
    the pipelines draw from ``np.random``, seeded here. With ``history``
    given, the loop appends a record of each event to it: ``{'kind':
    'batch', 'iter', 'indices'}`` for each batch taken, ``'log'`` (``iter``,
    ``time`` and ``data`` in s/iter over the interval, ``log_vars``),
    ``'eval'`` (``iter``, ``metrics``) and ``'checkpoint'`` (``iter``,
    ``path``). Returns the train state."""
    device = resolve_device(device)
    if work_dir:
        os.makedirs(work_dir, exist_ok=True)
    logger = get_root_logger(
        osp.join(work_dir, 'train.log') if work_dir else None)
    _refuse_waiting(cfg)
    set_random_seed(seed)
    apply_device_normalize(cfg)

    train_ds = build_dataset(cfg.data['train'])
    loader = build_dataloader(
        train_ds, cfg.data.get('samples_per_gpu', 2),
        cfg.data.get('workers_per_gpu', 2), shuffle=True, seed=seed,
        drop_last=True, infinite=True, pin_memory=device.type == 'cuda',
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

    log_interval = (cfg.get('log_config') or {}).get('interval', 50)
    ckpt_interval = (cfg.get('checkpoint_config') or {}).get('interval',
                                                             4000)
    eval_cfg = cfg.get('evaluation') or {}
    eval_interval = eval_cfg.get('interval', 4000)
    step_fn = algo.make_train_step(norm['mean'], norm['std'])
    compress_gt = bool(cfg.data.get('device_normalize'))
    prefetcher = BatchPrefetcher(iter(loader),
                                 make_to_device(device, compress_gt))

    # preemption: SIGTERM / SIGUSR1 ask for a checkpoint and a clean exit
    # at the next iteration boundary (handlers install only in the main
    # thread)
    preempt = {'sig': None}
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
            state, log_vars = step_fn(state, tensors,
                                      step_generator(seed, it))
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
            if work_dir and preempt['sig'] is not None:
                checkpoint(it + 1)
                print_log(f'preemption signal {preempt["sig"]}: exiting '
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
    if work_dir and preempt['sig'] is None and \
            state.step % ckpt_interval != 0:
        checkpoint(state.step)
    return state


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
    whole image (the EvalHook, ``eval_hooks.py:45-133``); returns the
    dataset's ``evaluate`` metrics."""
    student = state.student
    was_training = student.training
    student.eval()
    try:
        results = single_gpu_test(student, val['loader'], pre_eval=True)
    finally:
        student.train(was_training)
    return val['dataset'].evaluate(results,
                                   metric=eval_cfg.get('metric', 'mIoU'),
                                   logger=logger)
