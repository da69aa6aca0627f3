"""Model registries and builders (port of ``pfst_tpu/models/builder.py``).

One ``MODELS`` registry aliased as BACKBONES/NECKS/HEADS/LOSSES/
SEGMENTORS/DISCRIMINATORS/UDA, as in ``rsiseg/models/builder.py:8-17``;
``build_train_model`` dispatches ``cfg.uda`` against ``cfg.model``.
"""
from __future__ import annotations

import copy

import torch

from ..utils.misc import resolve_device
from ..utils.registry import Registry

MODELS = Registry('models')

BACKBONES = MODELS
NECKS = MODELS
HEADS = MODELS
LOSSES = MODELS
SEGMENTORS = MODELS
DISCRIMINATORS = MODELS
UDA = MODELS


def build_backbone(cfg):
    return BACKBONES.build(cfg)


def build_neck(cfg):
    return NECKS.build(cfg)


def build_head(cfg):
    return HEADS.build(cfg)


def build_loss(cfg):
    return LOSSES.build(cfg)


def build_discriminator(cfg):
    return DISCRIMINATORS.build(cfg)


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


def build_train_model(cfg, train_cfg=None, test_cfg=None, device='cuda'):
    """The training-time model (``pfst_tpu/models/builder.py:67-82``).

    With ``cfg.uda`` set, the UDA algorithm, given the segmentor config,
    the runner's ``max_iters`` and ``device`` (where ``init_state`` puts
    the student and the teacher); with a ``cfg.model`` of a domain-adaptor
    type, that orchestrator, given ``device``; else the segmentor on
    ``device``. ``device`` defaults to the card and must exist."""
    device = resolve_device(device)
    cfg = copy.deepcopy(cfg if isinstance(cfg, dict) else cfg.to_dict())
    if cfg.get('uda') is not None:
        uda_cfg = copy.deepcopy(cfg['uda'])
        uda_cfg['model'] = copy.deepcopy(cfg['model'])
        if 'max_iters' not in uda_cfg:
            uda_cfg['max_iters'] = cfg['runner']['max_iters']
        return UDA.build(uda_cfg, device=device)
    from .segmentors.domain_adaptor import _DomainAdaptorBase
    cls = SEGMENTORS.get(cfg['model'].get('type'))
    if isinstance(cls, type) and issubclass(cls, _DomainAdaptorBase):
        return SEGMENTORS.build(cfg['model'], device=device)
    return build_segmentor(cfg['model'], train_cfg=train_cfg,
                           test_cfg=test_cfg).to(device)
