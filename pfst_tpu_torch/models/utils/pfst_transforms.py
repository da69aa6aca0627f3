"""Geometric-augmentation replay (port of
``pfst_tpu/models/utils/pfst_transforms.py``), on NCHW tensors.

``transform_by_metas`` replays what the pipeline recorded onto the
teacher's outputs, in the reference's order: resize -> crop -> rot90 ->
flip -> pad. The shape-changing stages (``scale_factor``, ``crop_bbox``,
``pad_shape``) take Python values; ``rotate_k`` and the flips take
per-sample integer tensors (B,), applied on the device by selection, so
the replay reads nothing back to the host. A recorded rotation needs
square data (the four rotations are selected among), as in the JAX file.

The two deliberate deviations from the reference that the JAX file keeps
(``pfst_transforms.py:12-21``): ``h_scale`` resizes H and ``w_scale`` W
(the reference applies the width scale to the height axis; the recorded
factors are equal in every shipped pipeline), and the pad grows H by
``pad_H - H`` and W by ``pad_W - W`` with fill -1 (the reference pads by
the width delta twice).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...ops import resize


def proportional_crop(data: torch.Tensor, crop_bbox, scale: float
                      ) -> torch.Tensor:
    """Crop (B, C, H, W) by a bbox ``(y1, y2, x1, x2)`` recorded at full
    resolution, rescaled to this map's stride (``pfst_transforms.py:31-
    37``)."""
    y1, y2, x1, x2 = (int(v * scale) for v in crop_bbox)
    return data[:, :, y1:y2, x1:x2]


def _per_sample(value, b, device):
    return torch.as_tensor(value, dtype=torch.int64, device=device
                           ).reshape(-1).expand(b)


def _select(cond, a, b):
    return torch.where(cond.view(-1, 1, 1, 1), a, b)


def transform_by_metas(data: torch.Tensor, metas: dict,
                       scale: float = 1 / 8.) -> torch.Tensor:
    """Replay the recorded augmentations onto (B, C, H, W) ``data``
    (``pfst_transforms.py:59-114``)."""
    if metas.get('scale_factor') is not None:
        sf = metas['scale_factor']
        h_scale, w_scale = (float(sf[1]), float(sf[0])) \
            if hasattr(sf, '__len__') else (float(sf), float(sf))
        new_h = int(data.shape[2] * h_scale)
        new_w = int(data.shape[3] * w_scale)
        if (new_h, new_w) != tuple(data.shape[2:]):
            data = resize(data, size=(new_h, new_w), mode='bilinear',
                          align_corners=False)

    if metas.get('crop_bbox') is not None:
        data = proportional_crop(data, metas['crop_bbox'], scale)

    b, dev = data.shape[0], data.device
    rotate_k = metas.get('rotate_k')
    flip_v = _per_sample(metas.get('flip_vertical', 0), b, dev)
    flip_h = _per_sample(metas.get('flip_horizontal', 0), b, dev)
    # the 'flip' / 'flip_direction' form (``pfst_transforms.py:91-97``)
    if metas.get('flip', False):
        direction = metas.get('flip_direction', 'horizontal')
        if 'horizontal' in direction:
            flip_h = torch.ones_like(flip_h)
        if 'vertical' in direction:
            flip_v = torch.ones_like(flip_v)
    if rotate_k is not None:
        if data.shape[2] != data.shape[3]:
            raise ValueError(f'a recorded rotation needs square data, got '
                             f'{tuple(data.shape)}')
        k = _per_sample(rotate_k, b, dev).clamp(0, 3)
        out = data
        for r in (1, 2, 3):
            out = _select(k == r, torch.rot90(data, r, dims=(2, 3)), out)
        data = out
    data = _select(flip_v > 0, data.flip(2), data)
    data = _select(flip_h > 0, data.flip(3), data)

    if metas.get('pad_shape') is not None:
        pad_h = int(metas['pad_shape'][0] * scale)
        pad_w = int(metas['pad_shape'][1] * scale)
        h, w = data.shape[2:]
        if pad_h != h or pad_w != w:
            data = F.pad(data, (0, max(pad_w - w, 0), 0, max(pad_h - h, 0)),
                         value=-1.0)
    return data
