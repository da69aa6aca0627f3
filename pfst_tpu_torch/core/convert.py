"""Carry weights from the JAX package's variable trees into the port.

``jax_variables_to_state_dict`` is the inverse of
``tools/convert_torch_checkpoint.py::convert_state_dict``: it takes the
JAX ``{'params', 'batch_stats'}`` tree (leaves as numpy arrays) and
returns a state dict with the rsiseg key names the port's modules
carry. ``torch_key_to_flax`` is the port's own copy of that tool's key
map (``convert_torch_checkpoint.py:47-151`` and, for the ViT,
``:350-395``), extended to mmseg's ``avg_down`` downsample
(``downsample.{1,2}`` after the pooling layer), the ``MultiLevelNeck`` and
the ``UPerHead``.
``load_jax_train_state`` carries a JAX ``UDATrainState`` into the port's
train state.
"""
from __future__ import annotations

import re
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

_BN_LEAVES = {
    'weight': ('params', 'scale'),
    'bias': ('params', 'bias'),
    'running_mean': ('batch_stats', 'mean'),
    'running_var': ('batch_stats', 'var'),
}


def _bn(suffix, path):
    leaf = _BN_LEAVES.get(suffix)
    return None if leaf is None else (leaf[0], path + ['norm', 'bn', leaf[1]])


def _backbone_key(rest, ndim):
    if rest[0] in ('pos_embed', 'cls_token', 'patch_embed', 'layers', 'ln1'):
        return _vit_key(rest)
    base = ['backbone_mod']
    if rest[0] == 'stem':
        idx = int(rest[1])
        conv_i = {0: 1, 3: 2, 6: 3}.get(idx)
        bn_i = {1: 1, 4: 2, 7: 3}.get(idx)
        if conv_i is not None and rest[2] == 'weight':
            return 'params', base + [f'stem_conv{conv_i}', 'conv', 'kernel']
        if bn_i is not None:
            return _bn(rest[2], base + [f'stem_conv{bn_i}'])
        return None
    if rest[0] == 'conv1' and rest[1] == 'weight':
        return 'params', base + ['conv1', 'conv', 'kernel']
    if rest[0] == 'bn1':
        return _bn(rest[1], base + ['conv1'])
    m = re.match(r'layer(\d+)$', rest[0])
    if not m:
        return None
    blk = base + [f'layer{m.group(1)}_block{rest[1]}']
    sub = rest[2]
    if sub.startswith('conv') and rest[3] == 'weight':
        return 'params', blk + [sub, 'conv', 'kernel']
    if sub.startswith('bn'):
        return _bn(rest[3], blk + [f'conv{sub[2:]}'])
    if sub == 'downsample':
        down = blk + ['downsample', 'conv']
        idx, suffix = int(rest[3]), rest[4]
        # (conv, bn), or (avg pool, conv, bn) with avg_down
        if suffix == 'weight' and ndim == 4 and idx in (0, 1):
            return 'params', down + ['conv', 'kernel']
        if idx in (1, 2):
            return _bn(suffix, down)
    return None


_LN_LEAVES = {'weight': 'scale', 'bias': 'bias'}
_DENSE_LEAVES = {'weight': 'kernel', 'bias': 'bias'}
_VIT_BLOCK = {'ln1': 'norm1', 'ln2': 'norm2', 'attn.attn.out_proj': 'proj',
              'ffn.layers.0.0': 'fc1', 'ffn.layers.1': 'fc2'}


def _vit_key(rest):
    """mmseg ViT keys (``convert_torch_checkpoint.py:350-395``)."""
    base = ['backbone_mod']
    if rest[0] in ('pos_embed', 'cls_token'):
        return 'params', base + [rest[0]]
    if rest[0] == 'patch_embed' and rest[1] == 'projection':
        leaf = _DENSE_LEAVES.get(rest[2])
        return None if leaf is None else ('params',
                                          base + ['patch_embed', leaf])
    if rest[0] == 'ln1':
        leaf = _LN_LEAVES.get(rest[1])
        return None if leaf is None else ('params',
                                          base + ['final_norm', leaf])
    blk = base + [f'block{rest[1]}']
    sub, leaf = '.'.join(rest[2:-1]), rest[-1]
    if sub == 'attn.attn' and leaf in ('in_proj_weight', 'in_proj_bias'):
        return 'params', blk + ['qkv', 'kernel' if leaf.endswith('weight')
                                else 'bias']
    if sub in _VIT_BLOCK:
        leaves = _LN_LEAVES if sub.startswith('ln') else _DENSE_LEAVES
        return None if leaf not in leaves else (
            'params', blk + [_VIT_BLOCK[sub], leaves[leaf]])
    return None


def _conv_module(rest, path):
    """mmcv ConvModule: conv.weight/bias, bn.*; DepthwiseSeparable
    nests two of them."""
    if rest[0] == 'conv':
        leaf = {'weight': 'kernel', 'bias': 'bias'}.get(rest[1])
        return None if leaf is None else (
            'params', path + ['conv', leaf])
    if rest[0] == 'bn':
        return _bn(rest[1], path)
    if rest[0] in ('depthwise_conv', 'pointwise_conv'):
        return _conv_module(rest[1:], path + [rest[0]])
    return None


_HEADS = {'decode_head': 'decode_head_mod', 'auxiliary_head': 'aux_heads_0'}


def _neck_key(r):
    """MultiLevelNeck: ``lateral_convs.{i}`` and ``convs.{i}``."""
    name = {'lateral_convs': 'lateral', 'convs': 'conv'}.get(r[0])
    return None if name is None else _conv_module(
        r[2:], ['neck_mod', f'{name}{r[1]}'])


def _head_key(top, r, uper=False):
    base = [_HEADS[top]]
    if uper:
        # UPerHead: mmseg's names to the JAX file's
        if r[0] == 'psp_modules':
            return _conv_module(r[3:], base + ['ppm', f'pool{r[1]}'])
        if r[0] in ('lateral_convs', 'fpn_convs'):
            name = 'lateral' if r[0] == 'lateral_convs' else 'fpn_conv'
            return _conv_module(r[2:], base + [f'{name}{r[1]}'])
        if r[0] in ('bottleneck', 'fpn_bottleneck'):
            name = 'psp_bottleneck' if r[0] == 'bottleneck' else r[0]
            return _conv_module(r[1:], base + [name])
    if r[0] == 'image_pool':
        # Sequential(AdaptiveAvgPool2d, ConvModule)
        return _conv_module(r[2:], base + ['image_pool_conv'])
    if r[0] == 'aspp_modules':
        return _conv_module(r[2:], base + ['aspp_modules', f'branch{r[1]}'])
    if r[0] in ('bottleneck', 'c1_bottleneck', 'conv_cat'):
        return _conv_module(r[1:], base + [r[0]])
    if r[0] == 'sep_bottleneck':
        return _conv_module(r[2:], base + [f'sep_bottleneck{int(r[1]) + 1}'])
    if r[0] == 'convs':
        return _conv_module(r[2:], base + [f'conv{r[1]}'])
    if r[0] == 'conv_seg':
        leaf = {'weight': 'kernel', 'bias': 'bias'}.get(r[1])
        return None if leaf is None else (
            'params', base + ['cls', 'conv_seg', leaf])
    return None


def torch_key_to_flax(key: str, ndim: int,
                      uper: bool = False) -> Optional[Tuple[str, list]]:
    """Map one rsiseg state-dict key (of a tensor with ``ndim`` dims) to
    ``(collection, path)`` in the JAX tree, or None. ``uper``: the key's
    head is a ``UPerHead`` (whose ``bottleneck`` is the JAX file's
    ``psp_bottleneck``, where other heads keep the name)."""
    parts = key.split('.')
    if parts[0] == 'backbone':
        return _backbone_key(parts[1:], ndim)
    if parts[0] == 'neck':
        return _neck_key(parts[1:])
    if parts[0] in _HEADS:
        return _head_key(parts[0], parts[1:], uper)
    return None


def _leaf(tree, path):
    node = tree
    for k in path:
        if not isinstance(node, Mapping) or k not in node:
            return None
        node = node[k]
    return node


def jax_variables_to_state_dict(
        variables: Mapping,
        template: Mapping[str, torch.Tensor]) -> dict:
    """JAX ``{'params', 'batch_stats'}`` tree -> port state dict.

    ``template`` is the port model's ``state_dict()``: it names the keys
    to fill and their shapes. Conv kernels go HWIO -> OIHW (depthwise
    ``(3, 3, 1, C)`` -> ``(C, 1, 3, 3)``), Dense kernels (in, out) ->
    (out, in); LayerNorm scales become weights, and ``pos_embed`` and
    ``cls_token`` carry as they are. Raises ``KeyError`` naming every key
    of the port that has no source in ``variables``.
    """
    uper = {k.split('.')[0] for k in template if '.fpn_bottleneck.' in k}
    out, missing = {}, []
    for key, ref in template.items():
        if key.endswith('num_batches_tracked'):
            out[key] = torch.zeros_like(ref)
            continue
        mapped = torch_key_to_flax(key, ref.ndim,
                                   uper=key.split('.')[0] in uper)
        leaf = None if mapped is None else _leaf(
            variables.get(mapped[0], {}), mapped[1])
        if leaf is None:
            missing.append(key)
            continue
        arr = np.asarray(leaf, dtype=np.float32)
        if arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        elif arr.ndim == 2:
            arr = arr.T                      # Dense (in, out) -> (out, in)
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f'{key}: source shape {arr.shape} does not '
                             f'match the port\'s {tuple(ref.shape)}')
        # a copy: the leaves may be read-only views of JAX arrays
        out[key] = torch.from_numpy(np.array(arr)).to(ref.dtype)
    if missing:
        raise KeyError(f'no source in the JAX variables for {missing}')
    return out


def load_jax_train_state(jax_state, state):
    """Load a JAX ``UDATrainState`` (``params``, ``batch_stats``,
    ``ema_params``, ``ema_batch_stats``, ``step``; leaves as arrays) into
    the port's ``UDATrainState``: the student gets ``params`` and
    ``batch_stats``, the teacher ``ema_params`` and ``ema_batch_stats``,
    and ``step`` carries over, with the optimizer's LR schedule resumed
    there. The optimizer's moments do not carry over. Raises ``KeyError``
    for any key of either module without a source."""
    for module, params, stats in (
            (state.student, jax_state.params, jax_state.batch_stats),
            (state.teacher, jax_state.ema_params,
             jax_state.ema_batch_stats)):
        ref = module.state_dict()
        sd = jax_variables_to_state_dict(
            {'params': params, 'batch_stats': stats}, ref)
        module.load_state_dict({k: v.to(ref[k].device)
                                for k, v in sd.items()})
    state.step = int(np.asarray(jax_state.step))
    if state.optimizer is not None:
        state.optimizer.set_step(state.step)
    return state
