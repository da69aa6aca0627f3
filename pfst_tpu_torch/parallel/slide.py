"""Sliding-window scene inference spread over the ranks of a group
(port of ``pfst_tpu/parallel/slide.py``).

The JAX file shards a scene's static window grid over the ``data`` mesh
and assembles the overlap-averaged logits on the host. Here each rank
runs its share of the grid (windows ``rank::world``) through the model,
adds the logits into its overlap sum and count, and one ``all_reduce``
of each gives every rank the whole scene. The windows and their
arithmetic are ``EncoderDecoder.slide_inference``'s; only the order of
the additions where windows of two ranks overlap differs.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist

from .mesh import default_group, get_dist_info


def window_grid(h_img: int, w_img: int, crop: Tuple[int, int],
                stride: Tuple[int, int]):
    """The reference grid (right- and bottom-aligned windows): the
    windows' top-left corners (N, 2) and the crop clipped to the scene."""
    h_crop, w_crop = min(crop[0], h_img), min(crop[1], w_img)
    h_stride, w_stride = stride
    h_grids = max(h_img - h_crop + h_stride - 1, 0) // h_stride + 1
    w_grids = max(w_img - w_crop + w_stride - 1, 0) // w_stride + 1
    coords = []
    for hi in range(h_grids):
        for wi in range(w_grids):
            y1 = max(min(hi * h_stride + h_crop, h_img) - h_crop, 0)
            x1 = max(min(wi * w_stride + w_crop, w_img) - w_crop, 0)
            coords.append((y1, x1))
    return np.asarray(coords, np.int32), (h_crop, w_crop)


@torch.inference_mode()
def sharded_slide_inference(model, scene: torch.Tensor,
                            crop: Tuple[int, int],
                            stride: Tuple[int, int]) -> torch.Tensor:
    """scene (C, H, W), normalized, on the model's device -> the
    overlap-averaged logits (num_classes, H, W) fp32, the same on every
    rank of the default process group (one process without one; a rank
    may have no window). The model runs in its current mode, one window
    at a time, through ``encode_decode``."""
    group = default_group()
    rank, world = get_dist_info()
    _, h_img, w_img = scene.shape
    coords, (h_crop, w_crop) = window_grid(h_img, w_img, crop, stride)
    preds = scene.new_zeros((model.num_classes, h_img, w_img),
                            dtype=torch.float32)
    count = scene.new_zeros((1, h_img, w_img), dtype=torch.float32)
    for y1, x1 in coords[rank::world].tolist():
        logit, _ = model.encode_decode(
            scene[None, :, y1:y1 + h_crop, x1:x1 + w_crop])
        preds[:, y1:y1 + h_crop, x1:x1 + w_crop] += logit[0]
        count[:, y1:y1 + h_crop, x1:x1 + w_crop] += 1
    if group is not None:
        packet = torch.cat([preds, count])
        dist.all_reduce(packet, group=group)
        preds, count = packet[:-1], packet[-1:]
    return preds / count
