"""Build a segmentor and label single images (port of
``pfst_tpu/apis/inference.py``).

Checkpoints are the port's torch files (``core/checkpoint.py``) or any
rsiseg-layout state dict; Orbax checkpoints of the JAX package are
carried over by ``tools/convert_jax_checkpoint_torch.py``.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from ..core.checkpoint import extract_student, load_checkpoint
from ..datasets.pipelines import Compose
from ..models import build_segmentor
from ..models.segmentors.domain_adaptor import student_cfg
from ..utils.config import Config
from ..utils.misc import resolve_device
from .test import _finalize_views, make_inference_fn, normalize_views


def init_segmentor(config: Union[str, Config],
                   checkpoint: Optional[str] = None,
                   device: Union[str, torch.device] = 'cuda'):
    """Build a segmentor in eval mode on ``device``.

    Weights come from ``checkpoint`` when it is given, else from the JAX
    package's initializers drawn from a generator seeded with 0
    (``model.init_weights`` takes another). Weights are made on the CPU
    and then moved, so the same model comes out on every device. A
    domain adaptor's config gives its student.
    """
    device = resolve_device(device)
    if isinstance(config, str):
        config = Config.fromfile(config)
    model_cfg = student_cfg(dict(config.model))
    model_cfg['pretrained'] = None
    model_cfg.pop('train_cfg', None)
    test_cfg = model_cfg.pop('test_cfg', None)
    model = build_segmentor(model_cfg, test_cfg=test_cfg)
    if checkpoint is not None:
        model.load_state_dict(extract_student(load_checkpoint(checkpoint)))
    else:
        model.init_weights(torch.Generator().manual_seed(0))
    model.cfg = config
    return model.to(device).eval()


def inference_segmentor(model, img) -> np.ndarray:
    """Label one image, a path or an (H, W, 3) BGR uint8 array, through
    the config's test pipeline (``data.test.pipeline``): the views'
    logits rescaled to the image's size, softmaxed, summed and argmaxed
    (``apis/inference.py:43-66``). Returns the (H, W) label map."""
    pipeline = list(model.cfg.data['test']['pipeline'])
    if isinstance(img, np.ndarray):
        pipeline = pipeline[1:]
        data = dict(img=img, img_shape=img.shape, ori_shape=img.shape,
                    img_fields=['img'], seg_fields=[], filename=None,
                    ori_filename=None, scale_factor=1.0)
    else:
        data = dict(img_info=dict(filename=img), img_prefix=None,
                    seg_prefix=None, seg_fields=[])
    data = Compose(pipeline)(data)
    imgs, metas = data['img'], data['img_metas']
    if not isinstance(imgs, list):
        imgs, metas = [imgs], [metas]
    device = next(model.parameters()).device
    views = normalize_views(imgs, metas, device)
    infer = make_inference_fn(model)
    return _finalize_views(model, [infer(v) for v in views], metas,
                           metas[0]['ori_shape'][:2])
