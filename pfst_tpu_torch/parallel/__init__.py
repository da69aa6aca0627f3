"""Parallelism over ``torch.distributed`` groups (port of
``pfst_tpu/parallel``): data parallelism (``mesh.py``, ``slide.py``), the
GSPMD modes ZeRO-1/3 (``zero.py``) and tensor parallelism (``tp.py``) on
a global batch (``global_batch.py``), GPipe (``pp.py``), the
expert-parallel MoE (``ep.py``) and spatially sharded inference and
training (``spatial.py``), their collectives in ``comm.py``."""
from .global_batch import GlobalBatch, is_global_batch, split_forwards
from .mesh import (average_buffers, average_gradients, average_log_vars,
                   broadcast_state, default_group, get_dist_info,
                   gradient_norm, init_distributed, make_sharded_train_step,
                   rank_device, replicas_agree, resolve_backend)
from .slide import sharded_slide_inference, window_grid
from .spatial import (SpatialBatch, get_spatial_layout,
                      make_spatial_global_step, make_spatial_train_step,
                      shard_spatial_batch)
from .sync_bn import SyncBatchNorm, sync_bn_group

__all__ = ['average_buffers', 'average_gradients', 'average_log_vars',
           'broadcast_state', 'default_group', 'get_dist_info',
           'GlobalBatch', 'gradient_norm', 'is_global_batch',
           'split_forwards',
           'init_distributed', 'make_sharded_train_step', 'rank_device',
           'replicas_agree', 'resolve_backend', 'sharded_slide_inference',
           'window_grid', 'SpatialBatch', 'get_spatial_layout',
           'make_spatial_global_step', 'make_spatial_train_step',
           'shard_spatial_batch',
           'SyncBatchNorm', 'sync_bn_group']
