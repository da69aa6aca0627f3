"""UDA base: a student segmentor and its EMA teacher (port of
``pfst_tpu/models/uda/uda_decorator.py``).

The JAX file keeps the train state as an immutable tree; here
``UDATrainState`` holds the two modules, the optimizer and the step, and
a train step updates them in place: the EMA update writes the teacher's
parameters, the student's BN running statistics advance in its forward
passes, and the optimizer writes the student's parameters.
"""
from __future__ import annotations

import contextlib
import copy
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn as nn

from ..builder import build_segmentor


@dataclass
class UDATrainState:
    """The port of the JAX ``UDATrainState``: ``student`` holds ``params``
    and ``batch_stats``, ``teacher`` holds ``ema_params`` and
    ``ema_batch_stats``, ``optimizer`` holds ``opt_state``, and ``imnet``,
    the frozen reference of the feature distance, holds ``imnet_params``
    (None when the distance is off)."""
    student: nn.Module
    teacher: nn.Module
    optimizer: object
    step: int = 0
    imnet: Optional[nn.Module] = None


def maybe_normalize_images(batch: dict, mean, std) -> dict:
    """Deferred normalization: NCHW image tensors (keys holding ``img``)
    that arrive as uint8 or float16 on the 0-255 scale are normalized;
    float32 images pass through (``uda_decorator.py:38-51``)."""
    out = dict(batch)
    for k, v in batch.items():
        if 'img' in k and isinstance(v, torch.Tensor) and \
                v.dtype in (torch.uint8, torch.float16):
            m = torch.as_tensor(mean, dtype=torch.float32,
                                device=v.device).view(1, -1, 1, 1)
            s = torch.as_tensor(std, dtype=torch.float32,
                                device=v.device).view(1, -1, 1, 1)
            out[k] = (v.float() - m) / s
    return out


@contextlib.contextmanager
def batch_stats_forward(module: nn.Module):
    """Train-mode BN that normalizes by the batch statistics and leaves
    the running statistics untouched, with dropout off: the teacher
    forward of the JAX step (BN with ``train=True`` and the updates
    discarded, no dropout rng). BN that the module keeps in eval mode
    (``norm_eval``, frozen stages) stays so."""
    was_training = module.training
    module.train()
    bns = [m for m in module.modules()
           if isinstance(m, nn.modules.batchnorm._BatchNorm)]
    drops = [m for m in module.modules()
             if isinstance(m, nn.modules.dropout._DropoutNd)]
    tracked = [m.track_running_stats for m in bns]
    for m in bns:
        m.track_running_stats = False
    for m in drops:
        m.eval()
    try:
        yield module
    finally:
        for m, t in zip(bns, tracked):
            m.track_running_stats = t
        module.train(was_training)


class UDADecorator:
    """Construction, the train state and the EMA update."""

    def __init__(self, device='cuda', **cfg):
        self.cfg = cfg
        self.device = torch.device(device)
        self.model_cfg = copy.deepcopy(cfg['model'])
        self.train_cfg = cfg['model'].get('train_cfg')
        self.test_cfg = cfg['model'].get('test_cfg')
        self.num_classes = cfg['model']['decode_head']['num_classes']
        self.max_iters = cfg.get('max_iters', 40000)

    # the feature distance's frozen reference (``imnet_feature_dist_
    # lambda > 0``); set by the algorithms that have one
    enable_fdist = False

    def init_state(self, generator: torch.Generator, tx) -> UDATrainState:
        """Student weights from the JAX package's initializers drawn from
        ``generator``, the teacher a copy of the student
        (``uda_decorator.py:72-99``), and with the feature distance on, the
        frozen reference a copy of the *initial* student; all on
        ``self.device``. ``tx`` is a ``build_optimizer`` factory, bound to
        the student's parameters."""
        student = build_segmentor(self.model_cfg).init_weights(generator)
        frozen = [copy.deepcopy(student)
                  for _ in range(2 if self.enable_fdist else 1)]
        for module in frozen:
            for p in module.parameters():
                p.requires_grad_(False)
        for module in [student] + frozen:
            module.to(self.device).train()
        return UDATrainState(student=student, teacher=frozen[0],
                             optimizer=tx(student), step=0,
                             imnet=frozen[1] if self.enable_fdist else None)

    @torch.no_grad()
    def ema_update(self, state: UDATrainState, alpha: float):
        """teacher = a * teacher + (1 - a) * student on the parameters,
        ``a = min(1 - 1 / (step + 1), alpha)`` (``uda_decorator.py:101-
        113``); before the forward, so step 0 copies the student."""
        a = min(1.0 - 1.0 / (state.step + 1.0), alpha)
        ema = list(state.teacher.parameters())
        torch._foreach_mul_(ema, a)
        torch._foreach_add_(ema, list(state.student.parameters()),
                            alpha=1.0 - a)
        return state
