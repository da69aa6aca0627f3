"""Fold inference-mode BatchNorm into the conv before it (port of
``pfst_tpu/core/fold_bn.py``).

Every ``ConvModule``-shaped pair of the JAX tree, ``X/conv/kernel`` with
``X/norm/bn/{scale, bias, mean, var}``, is found through the port's key
map (``core.convert.torch_key_to_flax``) and rewritten with the JAX
file's formulas: the kernel absorbs ``scale / sqrt(var + eps)`` (eps the
JAX file's 1e-5), the conv's bias goes to zero and the BN becomes a pure
bias add (scale 1, mean 0, var ``1 - eps``), so the folded state dict
still carries across to the JAX tree and the eval output is the
unfolded model's.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch

from .convert import (head_prefix, key_families, lraspp_heads,
                      segformer_heads, torch_key_to_flax, uper_heads)

BN_EPS_DEFAULT = 1e-5


def _jax_keys(sd: Mapping[str, torch.Tensor], backbone=None, neck=None
              ) -> Dict[tuple, str]:
    """(collection, *JAX path) -> state-dict key, for the keys the map
    carries."""
    uper, segformer = uper_heads(sd), segformer_heads(sd)
    lraspp = lraspp_heads(sd)
    out = {}
    for key, t in sd.items():
        mapped = torch_key_to_flax(key, t.ndim,
                                   uper=head_prefix(key) in uper,
                                   backbone=backbone, neck=neck,
                                   segformer=head_prefix(key) in segformer,
                                   lraspp=head_prefix(key) in lraspp)
        if mapped is not None:
            out[(mapped[0], *mapped[1])] = key
    return out


def fold_state_dict(sd: Mapping[str, torch.Tensor],
                    eps: float = BN_EPS_DEFAULT,
                    backbone: Optional[str] = None,
                    neck: Optional[str] = None) -> dict:
    """A new state dict with every conv + BN pair folded; ``backbone``,
    ``neck``: the model's ``key_families``."""
    out = {k: v.clone() for k, v in sd.items()}
    keys = _jax_keys(sd, backbone, neck)
    for path, kkey in keys.items():
        if path[0] != 'params' or path[-2:] != ('conv', 'kernel'):
            continue
        base = path[1:-2]
        bn = {leaf: keys.get((coll, *base, 'norm', 'bn', leaf))
              for coll, leaf in (('params', 'scale'), ('params', 'bias'),
                                 ('batch_stats', 'mean'),
                                 ('batch_stats', 'var'))}
        if any(v is None for v in bn.values()):
            continue
        scale, bias = out[bn['scale']], out[bn['bias']]
        mean, var = out[bn['mean']], out[bn['var']]
        inv = scale / torch.sqrt(var + eps)
        kernel = out[kkey]
        out[kkey] = kernel * inv.to(kernel.dtype).view(
            -1, *([1] * (kernel.dim() - 1)))
        bkey = keys.get(('params', *base, 'conv', 'bias'))
        folded = (out[bkey] - mean) * inv if bkey else -mean * inv
        if bkey:
            out[bkey] = torch.zeros_like(out[bkey])
        out[bn['scale']] = torch.ones_like(scale)
        out[bn['bias']] = (folded + bias).to(bias.dtype)
        out[bn['mean']] = torch.zeros_like(mean)
        out[bn['var']] = torch.full_like(var, 1.0 - eps)
    return out


def fold_batch_norms(model_or_sd, eps: float = BN_EPS_DEFAULT):
    """Fold every conv + BN pair: a state dict gives a new one (keys with
    the ResNet and head families; pass a model for the others); a model
    is folded in place and returned."""
    if isinstance(model_or_sd, torch.nn.Module):
        model = model_or_sd
        folded = fold_state_dict(model.state_dict(), eps,
                                 **key_families(model))
        model.load_state_dict(folded)
        return model
    return fold_state_dict(model_or_sd, eps)
