"""Data parallelism over a ``torch.distributed`` group (port of
``pfst_tpu/parallel``: ``mesh.py`` and ``slide.py``; tensor, pipeline,
expert, spatial and ZeRO sharding wait for ROADMAP A14c)."""
from .mesh import (average_buffers, average_gradients, average_log_vars,
                   broadcast_state, default_group, get_dist_info,
                   init_distributed, make_sharded_train_step,
                   rank_device, replicas_agree, resolve_backend)
from .slide import sharded_slide_inference, window_grid
from .sync_bn import SyncBatchNorm, sync_bn_group

__all__ = ['average_buffers', 'average_gradients', 'average_log_vars',
           'broadcast_state', 'default_group', 'get_dist_info',
           'init_distributed', 'make_sharded_train_step', 'rank_device',
           'replicas_agree', 'resolve_backend', 'sharded_slide_inference',
           'window_grid', 'SyncBatchNorm', 'sync_bn_group']
