"""Build a segmentor for inference (port of ``init_segmentor`` in
``pfst_tpu/apis/inference.py``).

Checkpoints are rsiseg-layout torch state-dict files. The JAX file's
Orbax checkpoints and ``inference_segmentor`` with its host pipeline are
not ported yet.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from ..models import build_segmentor
from ..utils.config import Config
from ..utils.misc import resolve_device


def _student_state_dict(obj) -> dict:
    """The student's weights from a saved checkpoint: the ``state_dict``
    entry if there is one, with ``module.`` and (for UDA checkpoints)
    ``model.`` prefixes stripped and ``ema_model.`` dropped, as
    ``tools/test.py:237-242`` of rsiseg does."""
    sd = obj.get('state_dict', obj)
    sd = {k[len('module.'):] if k.startswith('module.') else k: v
          for k, v in sd.items()}
    if any(k.startswith('model.') for k in sd):
        sd = {k[len('model.'):]: v for k, v in sd.items()
              if k.startswith('model.')}
    return sd


def init_segmentor(config: Union[str, Config],
                   checkpoint: Optional[str] = None,
                   device: Union[str, torch.device] = 'cuda'):
    """Build a segmentor in eval mode on ``device``.

    Weights come from ``checkpoint`` (a torch state-dict file) when it is
    given, else from the JAX package's initializers drawn from a
    generator seeded with 0 (``model.init_weights`` takes another).
    Weights are made on the CPU and then moved, so the same model comes
    out on every device.
    """
    device = resolve_device(device)
    if isinstance(config, str):
        config = Config.fromfile(config)
    model_cfg = dict(config.model)
    model_cfg['pretrained'] = None
    model_cfg.pop('train_cfg', None)
    test_cfg = model_cfg.pop('test_cfg', None)
    model = build_segmentor(model_cfg, test_cfg=test_cfg)
    if checkpoint is not None:
        obj = torch.load(checkpoint, map_location='cpu', weights_only=True)
        model.load_state_dict(_student_state_dict(obj))
    else:
        model.init_weights(torch.Generator().manual_seed(0))
    model.cfg = config
    return model.to(device).eval()
