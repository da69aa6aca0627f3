"""PSANet's over-complete mask to a dense attention matrix (port of
``pfst_tpu/ops/psa_mask.py``).

At every position of an (h, w) map the mask holds a (mask_h, mask_w)
window of logits, one per displacement. ``psa_mask`` spreads them over
a dense (position, position) matrix laid out [k, q], so that the
aggregation is ``out[q] = sum_k attn[k, q] x[k]``:

* ``collect``:    attn[k, q] = mask at q, displacement k - q;
* ``distribute``: attn[k, q] = mask at k, displacement q - k.

Displacements outside the window are zero. Both directions are one
``torch.gather`` over the mask's channels with a static displacement
table, the second transposed. The table is built once per (h, w, mask)
with numpy and kept on the device that asks for it, also when the first
call runs in inference mode.
"""
from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch


def displacement_index(h: int, w: int, mask_h: int, mask_w: int):
    """``idx[x, y]``: the mask channel of the displacement x - y between
    flat positions x and y of an (h, w) grid, and ``valid[x, y]``: whether
    it lies inside the (mask_h, mask_w) window centred at (m - 1) // 2
    (mmcv's convention); numpy, (hw, hw)."""
    half_h, half_w = (mask_h - 1) // 2, (mask_w - 1) // 2
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing='ij')
    pi, pj = yy.reshape(-1), xx.reshape(-1)
    di = pi[:, None] - pi[None, :] + half_h
    dj = pj[:, None] - pj[None, :] + half_w
    valid = (di >= 0) & (di < mask_h) & (dj >= 0) & (dj < mask_w)
    return np.where(valid, di * mask_w + dj, 0), valid


@functools.lru_cache(maxsize=8)
def _table(h, w, mask_h, mask_w, device):
    """``displacement_index`` as tensors on ``device``, the last eight
    geometries kept. Not inference tensors, which a training call could
    not save for its backward, also when made inside a request."""
    idx, valid = displacement_index(h, w, mask_h, mask_w)
    with torch.inference_mode(False):
        return (torch.from_numpy(idx).to(device),
                torch.from_numpy(valid).to(device))


def psa_mask(mask: torch.Tensor, mask_size: Sequence[int],
             psa_type: str) -> torch.Tensor:
    """(B, mask_h * mask_w, H, W) over-complete logits -> (B, HW, HW)
    attention logits laid out [k, q], in the mask's type."""
    b, _, h, w = mask.shape
    mask_h, mask_w = mask_size
    idx, valid = _table(h, w, mask_h, mask_w, mask.device)
    flat = mask.reshape(b, mask_h * mask_w, h * w)
    # g[b, j, p] = flat[b, idx[j, p], p]: the logit at p for displacement
    # j - p, which 'collect' lays out as attn[j, p] and 'distribute'
    # transposes
    g = torch.gather(flat, 1, idx.expand(b, -1, -1))
    g = torch.where(valid, g, g.new_zeros(()))
    if psa_type == 'collect':
        return g
    if psa_type == 'distribute':
        return g.transpose(1, 2)
    raise ValueError(psa_type)
