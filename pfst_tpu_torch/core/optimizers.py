"""Optimizer and learning-rate schedule builders (port of
``pfst_tpu/core/optimizers.py``) on ``torch.optim``.

``build_lr_schedule`` gives every policy and warmup of the JAX file as a
function of the step. ``build_optimizer`` gives a factory that binds
AdamW, Adam or SGD (the JAX file's optax chains) to parameters, with the
schedule as a ``LambdaLR`` (update ``s`` uses ``schedule(s)``, as optax's
count does) and, with ``grad_clip``, optax's global-norm clip first. The
JAX file's ``paramwise_cfg`` (custom keys and layer decay),
``cumulative_iters`` and ``skip_nonfinite`` are not ported and raise.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Union

import torch


def build_lr_schedule(lr_config: Optional[dict], base_lr: float,
                      max_iters: int) -> Union[float, Callable[[int], float]]:
    """mmcv's LR policies with linear / constant / exp warmup
    (``optimizers.py:19-89``); ``base_lr`` when ``lr_config`` is None."""
    if lr_config is None:
        return base_lr
    cfg = dict(lr_config)
    policy = str(cfg.get('policy', 'poly'))
    warmup = cfg.get('warmup', None)
    warmup_iters = cfg.get('warmup_iters', 0)
    warmup_ratio = cfg.get('warmup_ratio', 1e-6)
    power = cfg.get('power', 1.0)
    min_lr = cfg.get('min_lr', 0.0)
    low = policy.lower()
    if low == 'cosineannealing':
        policy = 'CosineAnnealing'
    elif low in ('poly', 'fixed', 'step', 'exp', 'inv', 'linear'):
        policy = low
    else:
        raise ValueError(f'unsupported lr policy {policy}')

    def target_lr():
        target = cfg.get('min_lr')
        return base_lr * cfg.get('min_lr_ratio', 0.0) if target is None \
            else target

    def schedule(step: int) -> float:
        step = float(step)
        progress = min(max(step / max_iters, 0.0), 1.0)
        if policy == 'poly':
            # (max_iters - step) / max_iters, as the JAX file (no
            # cancellation near the end of training)
            remaining = min(max((max_iters - step) / max_iters, 0.0), 1.0)
            lr = (base_lr - min_lr) * remaining**power + min_lr
        elif policy == 'fixed':
            lr = base_lr
        elif policy == 'step':
            milestones = cfg['step'] if isinstance(
                cfg['step'], (list, tuple)) else [cfg['step']]
            lr = base_lr * cfg.get('gamma', 0.1)**sum(
                step >= m for m in milestones)
        elif policy == 'exp':
            lr = base_lr * cfg.get('gamma', 0.99)**step
        elif policy == 'inv':
            lr = base_lr * (1.0 + cfg.get('gamma', 0.1) * step)**(-power)
        elif policy == 'CosineAnnealing':
            target = target_lr()
            lr = target + 0.5 * (base_lr - target) * (
                1.0 + math.cos(math.pi * progress))
        else:   # linear
            target = target_lr()
            lr = base_lr + (target - base_lr) * progress
        if warmup_iters > 0 and step < warmup_iters:
            k = min(max(step / warmup_iters, 0.0), 1.0)
            if warmup == 'linear':
                lr = lr * (warmup_ratio + (1.0 - warmup_ratio) * k)
            elif warmup == 'constant':
                lr = lr * warmup_ratio
            elif warmup == 'exp':
                lr = lr * warmup_ratio**(1 - k)
        return lr

    return schedule


class ScheduledOptimizer:
    """A ``torch.optim`` optimizer with its LR schedule and optional
    global-norm gradient clip; ``step()`` applies one update.

    A parameter that got no gradient is updated with a zero one (weight
    decay still applies), as the JAX step updates every leaf."""

    def __init__(self, params, opt_cls, opt_kwargs: dict, schedule,
                 max_norm: Optional[float] = None):
        self.params = [p for p in params if p.requires_grad]
        base_lr = opt_kwargs['lr']
        self.optimizer = opt_cls(self.params, **opt_kwargs)
        if callable(schedule):
            factor = (lambda s: schedule(s) / base_lr) if base_lr \
                else (lambda s: 0.0)
            self.scheduler = torch.optim.lr_scheduler.LambdaLR(
                self.optimizer, factor)
        else:
            self.scheduler = None
        self.max_norm = max_norm

    def zero_grad(self):
        self.optimizer.zero_grad(set_to_none=True)

    @torch.no_grad()
    def clip_grads(self):
        """optax ``clip_by_global_norm``: scale by max_norm / norm when
        the norm reaches max_norm."""
        grads = [p.grad for p in self.params]
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g.float())
                         for g in grads]))
        scale = torch.where(norm < self.max_norm, 1.0,
                            self.max_norm / norm)
        torch._foreach_mul_(grads, scale)

    def step(self):
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.max_norm is not None:
            self.clip_grads()
        self.optimizer.step()
        if self.scheduler is not None:
            self.scheduler.step()

    def set_step(self, step: int):
        """Resume the schedule at update ``step`` (optax's count): the
        next ``step()`` uses ``schedule(step)``."""
        if self.scheduler is not None:
            self.scheduler = torch.optim.lr_scheduler.LambdaLR(
                self.optimizer, self.scheduler.lr_lambdas[0],
                last_epoch=step - 1)

    @property
    def lr(self) -> float:
        return self.optimizer.param_groups[0]['lr']


def build_optimizer(optimizer_cfg: dict,
                    lr_config: Optional[dict] = None,
                    max_iters: int = 40000,
                    grad_clip: Optional[dict] = None,
                    cumulative_iters: int = 1,
                    skip_nonfinite: int = 0):
    """A factory ``params -> ScheduledOptimizer`` from the reference's
    optimizer config (``optimizers.py:145-256``): AdamW (decoupled weight
    decay, optax's ``adamw``), Adam (optax's ``adam``: no weight decay,
    eps 1e-8) or SGD (``add_decayed_weights`` then momentum)."""
    cfg = dict(optimizer_cfg)
    opt_type = cfg.pop('type', 'AdamW')
    base_lr = cfg.pop('lr', 1e-3)
    if cfg.pop('paramwise_cfg', None) or cfg.pop('constructor', None) \
            not in (None, 'DefaultOptimizerConstructor'):
        raise NotImplementedError('paramwise_cfg and layer decay are not '
                                  'ported')
    if max(int(cumulative_iters or 1), 1) > 1:
        raise NotImplementedError('cumulative_iters is not ported')
    if skip_nonfinite:
        raise NotImplementedError('skip_nonfinite is not ported')
    if opt_type == 'AdamW':
        opt_cls = torch.optim.AdamW
        kwargs = dict(betas=tuple(cfg.get('betas', (0.9, 0.999))),
                      eps=cfg.get('eps', 1e-8),
                      weight_decay=cfg.get('weight_decay', 0.0))
    elif opt_type == 'Adam':
        opt_cls = torch.optim.Adam
        kwargs = dict(betas=tuple(cfg.get('betas', (0.9, 0.999))), eps=1e-8)
    elif opt_type == 'SGD':
        opt_cls = torch.optim.SGD
        kwargs = dict(momentum=cfg.get('momentum', 0.0),
                      nesterov=cfg.get('nesterov', False),
                      weight_decay=cfg.get('weight_decay', 0.0))
    else:
        raise ValueError(f'unsupported optimizer {opt_type}')
    schedule = build_lr_schedule(lr_config, base_lr, max_iters)
    kwargs['lr'] = base_lr
    max_norm = grad_clip.get('max_norm', 1.0) if grad_clip else None

    def bind(params) -> ScheduledOptimizer:
        return ScheduledOptimizer(params, opt_cls, kwargs, schedule,
                                  max_norm)

    return bind
