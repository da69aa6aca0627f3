"""Training-callback protocol (port of ``pfst_tpu/core/hooks/hook.py``).

In place of mmcv's hook inversion of control (``rsiseg/core/hook/``) the
explicit train loop calls a narrow set of callbacks with plain data: no
runner object, no priorities. ``train_segmentor`` builds the hooks of
``log_config.hooks`` and ``custom_hooks`` and passes each call a ``ctx``
dict with ``work_dir``, ``iter``, ``algo``, ``palette``,
``source_dataset``, ``cfg`` and, once a step has run, ``state``.
A hook that ends training (``_StopTraining``) must end it on every rank
of a process group: it sets ``all_ranks``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from ...utils.registry import Registry

HOOKS = Registry('hooks')


def build_hook(cfg):
    return HOOKS.build(dict(cfg))


class Hook:
    """Override any subset; all receive plain dicts. Under a process
    group the loop calls a hook on rank 0 alone (the writers: log,
    TensorBoard, W&B, profiler, plots) unless it sets ``all_ranks``."""

    all_ranks = False

    def before_run(self, ctx: Dict[str, Any]):
        pass

    def after_train_iter(self, ctx: Dict[str, Any],
                         log_vars: Dict[str, Any],
                         vis_states: Optional[Dict[str, Any]] = None):
        pass

    def after_eval(self, ctx: Dict[str, Any],
                   metrics: Dict[str, float]):
        pass

    def after_run(self, ctx: Dict[str, Any]):
        pass
