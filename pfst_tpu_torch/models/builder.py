"""Model registries and builders (port of ``pfst_tpu/models/builder.py``).

One ``MODELS`` registry aliased as BACKBONES/NECKS/HEADS/LOSSES/
SEGMENTORS, as in ``rsiseg/models/builder.py:8-17``.
"""
from __future__ import annotations

import copy

import torch

from ..utils.registry import Registry

MODELS = Registry('models')

BACKBONES = MODELS
NECKS = MODELS
HEADS = MODELS
LOSSES = MODELS
SEGMENTORS = MODELS


def build_backbone(cfg):
    return BACKBONES.build(cfg)


def build_neck(cfg):
    return NECKS.build(cfg)


def build_head(cfg):
    return HEADS.build(cfg)


def build_segmentor(cfg, train_cfg=None, test_cfg=None):
    """Build a segmentor module from config.

    ``cfg['dtype']`` may be a string: ``'bfloat16'`` turns on mixed
    precision, the port of the JAX package's flax dtype
    (``pfst_tpu/models/builder.py:52-54``): the segmentor runs its
    forward under ``torch.autocast`` with bf16 compute while parameters
    and BN statistics stay fp32."""
    cfg = copy.deepcopy(dict(cfg))
    if isinstance(cfg.get('dtype'), str):
        cfg['dtype'] = getattr(torch, cfg['dtype'])
    if train_cfg is not None and cfg.get('train_cfg') is not None:
        raise ValueError('train_cfg specified in both outer field and '
                         'segmentor field')
    if test_cfg is not None and cfg.get('test_cfg') is not None:
        raise ValueError('test_cfg specified in both outer field and '
                         'segmentor field')
    if train_cfg is not None:
        cfg['train_cfg'] = train_cfg
    if test_cfg is not None:
        cfg['test_cfg'] = test_cfg
    return SEGMENTORS.build(cfg)
