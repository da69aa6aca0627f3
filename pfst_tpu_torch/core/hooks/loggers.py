"""Logger hooks (port of ``pfst_tpu/core/hooks/loggers.py``).

``TextLoggerHook`` is a no-op: the train loop writes its log line itself.
The JAX file's ``TensorboardLoggerHook``, ``WandbHookSeg`` (with its
``MMSegWandbHook`` and ``WandbHookStatistics`` aliases) and
``ProfilerHook`` wait for the next A12 slice (``train_segmentor`` raises
for them by name).
"""
from __future__ import annotations

from .hook import HOOKS, Hook


@HOOKS.register_module()
class TextLoggerHook(Hook):

    def __init__(self, by_epoch=False, interval=50, **kwargs):
        self.interval = interval
