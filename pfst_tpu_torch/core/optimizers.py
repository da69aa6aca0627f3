"""Optimizer and learning-rate schedule builders (port of
``pfst_tpu/core/optimizers.py``) on ``torch.optim``.

``build_lr_schedule`` gives every policy and warmup of the JAX file as a
function of the step. ``build_optimizer`` gives a factory that binds
AdamW, Adam or SGD (the JAX file's optax chains) to parameters, with the
schedule as a ``LambdaLR`` (update ``s`` uses ``schedule(s)``, as optax's
count does), with ``grad_clip`` optax's global-norm clip first, and the
JAX file's ``paramwise_cfg`` (custom keys and layer decay),
``cumulative_iters`` (optax ``MultiSteps``) and ``skip_nonfinite`` (optax
``apply_if_finite``). ``build_optimizers`` gives a dict of factories for
a dict of configs (the adversarial adaptor's two optimizers).
"""
from __future__ import annotations

import math
import re
from typing import Callable, Dict, Optional, Union

import torch

from .convert import (discriminator_key_to_flax, head_prefix, key_families,
                      lraspp_heads, segformer_heads, torch_key_to_flax,
                      uper_heads)


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


def _label_custom_key(path: str, custom_keys) -> Optional[str]:
    """The ``custom_keys`` entry of ``path``: the longest key contained in
    it (``optimizers.py:92-101``), or None."""
    for key in sorted(custom_keys, key=len, reverse=True):
        if key in path:
            return key
    return None


def _layer_id_from_path(path: str, num_layers: int) -> int:
    """The depth of a parameter for layer-wise LR decay
    (``optimizers.py:104-122``): stems and embeddings 0, block i i + 1,
    heads ``num_layers + 1``. As in the JAX file, ``conv1`` anywhere in
    the path gives 0."""
    if any(k in path for k in ('stem', 'patch_embed', 'pos_embed',
                               'cls_token', 'conv1')):
        return 0
    m = re.search(
        r'(?:blocks?|layers?|stages?)[._]?(\d+)[_.]?(?:blocks?)?[._]?(\d+)?',
        path)
    if m and 'backbone' in path:
        return min(int(m.group(1)) + int(m.group(2) or 0), num_layers)
    if 'backbone' in path:
        return num_layers // 2
    return num_layers + 1


def param_paths(named_params, backbone: Optional[str] = None,
                neck: Optional[str] = None) -> Dict[str, str]:
    """Each parameter's name in the JAX package's tree, ``/``-joined
    (``backbone_mod/layer4_block0/conv1/conv/kernel``), where
    ``core.convert`` maps it, else its own name: the multipliers of
    ``paramwise_cfg`` and layer decay are read from these paths, as the JAX
    file reads them from the flax paths. ``backbone``, ``neck``: the
    model's ``core.convert.key_families``."""
    named = list(named_params)
    uper = uper_heads(n for n, _ in named)
    segformer = segformer_heads(n for n, _ in named)
    lraspp = lraspp_heads(n for n, _ in named)
    out = {}
    for name, p in named:
        mapped = torch_key_to_flax(name, p.ndim,
                                   uper=head_prefix(name) in uper,
                                   backbone=backbone, neck=neck,
                                   segformer=head_prefix(name) in segformer,
                                   lraspp=head_prefix(name) in lraspp) \
            or discriminator_key_to_flax(name)
        out[name] = '/'.join(mapped[1]) \
            if mapped and mapped[0] == 'params' else name
    return out


class ScheduledOptimizer:
    """A ``torch.optim`` optimizer with its LR schedule and the options of
    the JAX file's optax chain; ``step()`` applies one update.

    * ``groups``: ``(params, lr_mult, decay_mult)``, one torch param group
      each (``paramwise_cfg`` and layer decay; one group without them);
    * ``max_norm``: optax's global-norm clip, over every group;
    * ``cumulative_iters`` k > 1: optax ``MultiSteps`` (``optimizers.py:
      193-197, 248-251``): each ``step()`` folds the gradients into their
      running mean (Welford's update, optax's), and every k-th applies the
      update with that mean, clipped, and clears it; the others leave the
      parameters as they are. The schedule of update s is read at
      ``s * k + k - 1``;
    * ``skip_nonfinite`` N > 0: optax ``apply_if_finite``, outermost
      (``optimizers.py:252-255``): a step whose gradients hold a NaN or an
      Inf leaves the parameters, the moments, the accumulator and the
      schedule untouched, unless it is the (N + 1)-th such step in a row,
      which goes through. It guards what the optimizer holds only: the
      BN running statistics of the step's forward passes advance all the
      same, as JAX's do. The finiteness check reads one flag from the
      device each step.

    A parameter that got no gradient is updated with a zero one (weight
    decay still applies), as the JAX step updates every leaf."""

    def __init__(self, groups, opt_cls, opt_kwargs: dict, schedule,
                 max_norm: Optional[float] = None,
                 cumulative_iters: int = 1, skip_nonfinite: int = 0):
        base_lr = opt_kwargs['lr']
        torch_groups = []
        for params, lr_mult, decay_mult in groups:
            params = [p for p in params if p.requires_grad]
            if not params:
                continue
            group = dict(params=params, lr=base_lr * lr_mult)
            if 'weight_decay' in opt_kwargs:
                group['weight_decay'] = opt_kwargs['weight_decay'] * \
                    decay_mult
            torch_groups.append(group)
        self.params = [p for g in torch_groups for p in g['params']]
        self.optimizer = opt_cls(torch_groups, **opt_kwargs)
        self.k = max(int(cumulative_iters or 1), 1)
        self.skip_nonfinite = int(skip_nonfinite or 0)
        self.mini_step = 0
        self.acc = None
        self.notfinite_count = 0
        self.total_notfinite = 0
        if callable(schedule):
            k = self.k

            def factor(s):
                return schedule(s * k + k - 1) / base_lr if base_lr else 0.0
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

    @torch.no_grad()
    def step(self) -> bool:
        """One iteration's update; False where ``skip_nonfinite`` rejected
        it or ``cumulative_iters`` only accumulated."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        if self.skip_nonfinite:
            finite = bool(torch.stack([torch.isfinite(g).all()
                                       for g in grads]).all())
            self.notfinite_count = 0 if finite else self.notfinite_count + 1
            self.total_notfinite += 0 if finite else 1
            if not finite and self.notfinite_count <= self.skip_nonfinite:
                return False
        if self.k > 1:
            if self.acc is None:
                self.acc = [torch.zeros_like(g) for g in grads]
            torch._foreach_add_(self.acc, torch._foreach_div(
                torch._foreach_sub(grads, self.acc), float(self.mini_step
                                                           + 1)))
            emit = self.mini_step == self.k - 1
            self.mini_step = (self.mini_step + 1) % self.k
            if not emit:
                return False
            for g, a in zip(grads, self.acc):
                g.copy_(a)
                a.zero_()
        if self.max_norm is not None:
            self.clip_grads()
        self.optimizer.step()
        if self.scheduler is not None:
            self.scheduler.step()
        return True

    def set_step(self, step: int):
        """Resume at iteration ``step`` (optax's count): the next update
        uses ``schedule(step)``; with ``cumulative_iters`` k it is update
        ``step // k`` and the accumulator starts empty at micro-step
        ``step % k``."""
        self.mini_step = step % self.k
        self.acc = None
        if self.scheduler is not None:
            self.scheduler = torch.optim.lr_scheduler.LambdaLR(
                self.optimizer, self.scheduler.lr_lambdas[0],
                last_epoch=step // self.k - 1)

    def extra_state(self) -> dict:
        """What ``cumulative_iters`` and ``skip_nonfinite`` carry from step
        to step, for the checkpoint."""
        return dict(mini_step=self.mini_step,
                    acc=None if self.acc is None else
                    [a.detach().cpu().clone() for a in self.acc],
                    notfinite_count=self.notfinite_count,
                    total_notfinite=self.total_notfinite)

    def load_extra_state(self, extra: Optional[dict]):
        extra = extra or {}
        self.mini_step = int(extra.get('mini_step', 0))
        acc = extra.get('acc')
        self.acc = None if acc is None else [
            a.to(p.device, p.dtype) for a, p in zip(acc, self.params)]
        self.notfinite_count = int(extra.get('notfinite_count', 0))
        self.total_notfinite = int(extra.get('total_notfinite', 0))

    @property
    def lr(self) -> float:
        return self.optimizer.param_groups[0]['lr']


def _paramwise(optimizer_cfg: dict):
    """(cfg without the constructor keys, the per-path multiplier
    function or None), as the JAX file reads ``paramwise_cfg`` and the two
    mmcv constructor names (``optimizers.py:175-191, 222-241``)."""
    cfg = dict(optimizer_cfg)
    paramwise_cfg = cfg.pop('paramwise_cfg', None)
    constructor = cfg.pop('constructor', None)
    if constructor in ('LearningRateDecayOptimizerConstructor',
                       'LayerDecayOptimizerConstructor'):
        paramwise_cfg = dict(paramwise_cfg or {})
        if constructor == 'LayerDecayOptimizerConstructor':
            # the deprecated BEiT spelling: layer-wise, and
            # layer_decay_rate renamed
            paramwise_cfg['decay_type'] = 'layer_wise'
            if 'layer_decay_rate' in paramwise_cfg:
                paramwise_cfg['decay_rate'] = \
                    paramwise_cfg.pop('layer_decay_rate')
        else:
            paramwise_cfg.setdefault('decay_type', 'layer_wise')
    elif constructor not in (None, 'DefaultOptimizerConstructor'):
        raise ValueError(f'unsupported constructor {constructor}')
    if not paramwise_cfg:
        return cfg, None
    if paramwise_cfg.get('decay_type') in ('layer_wise', 'stage_wise'):
        num_layers = paramwise_cfg.get('num_layers', 12)
        rate = paramwise_cfg.get('decay_rate', 0.9)

        def layer_mults(path):
            lid = _layer_id_from_path(path, num_layers)
            return rate**(num_layers + 1 - lid), 1.0
        return cfg, layer_mults
    custom_keys = paramwise_cfg.get('custom_keys', {})

    def key_mults(path):
        key = _label_custom_key(path, custom_keys)
        if key is None:
            return 1.0, 1.0
        return (custom_keys[key].get('lr_mult', 1.0),
                custom_keys[key].get('decay_mult', 1.0))
    return cfg, key_mults


def build_optimizer(optimizer_cfg: dict,
                    lr_config: Optional[dict] = None,
                    max_iters: int = 40000,
                    grad_clip: Optional[dict] = None,
                    cumulative_iters: int = 1,
                    skip_nonfinite: int = 0):
    """A factory ``params -> ScheduledOptimizer`` from the reference's
    optimizer config (``optimizers.py:145-256``): AdamW (decoupled weight
    decay, optax's ``adamw``), Adam (optax's ``adam``: no weight decay,
    eps 1e-8) or SGD (``add_decayed_weights`` then momentum), with
    ``paramwise_cfg`` (``custom_keys``' ``lr_mult`` / ``decay_mult``, the
    longest matching key first), layer decay, ``grad_clip``,
    ``cumulative_iters`` and ``skip_nonfinite`` (``ScheduledOptimizer``).

    The factory takes a module, its ``named_parameters()``, or, without
    ``paramwise_cfg`` and layer decay, bare parameters. Multipliers are
    read from each parameter's JAX path (``param_paths``); a BEiT's or
    Swin's paths need the module, whose backbone names its key family."""
    cfg, mults = _paramwise(optimizer_cfg)
    opt_type = cfg.pop('type', 'AdamW')
    base_lr = cfg.pop('lr', 1e-3)
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
        families = key_families(params)
        if isinstance(params, torch.nn.Module):
            params = params.named_parameters()
        params = list(params)
        named = bool(params) and isinstance(params[0], tuple)
        if mults is None:
            groups = [([p[1] if named else p for p in params], 1.0, 1.0)]
        elif not named:
            raise ValueError('paramwise_cfg and layer decay need named '
                             'parameters (a module or named_parameters())')
        else:
            paths = param_paths(params, **families)
            by_mult: Dict[tuple, list] = {}
            for name, p in params:
                by_mult.setdefault(mults(paths[name]), []).append(p)
            groups = [(ps, *m) for m, ps in by_mult.items()]
        return ScheduledOptimizer(groups, opt_cls, kwargs, schedule,
                                  max_norm, cumulative_iters, skip_nonfinite)

    return bind


def build_optimizers(cfg: dict, lr_config=None, max_iters=40000,
                     grad_clip=None, cumulative_iters=1,
                     skip_nonfinite: int = 0):
    """A factory, or for a dict of optimizer configs (no ``type`` key: one
    per submodule, e.g. DomainAdaptorAdv's ``generator`` and
    ``discriminator``) a dict of factories (``optimizers.py:259-269``)."""
    if 'type' in cfg:
        return build_optimizer(cfg, lr_config, max_iters, grad_clip,
                               cumulative_iters, skip_nonfinite)
    return {name: build_optimizer(sub, lr_config, max_iters, grad_clip,
                                  cumulative_iters, skip_nonfinite)
            for name, sub in cfg.items()}
