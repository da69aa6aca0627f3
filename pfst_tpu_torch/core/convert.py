"""Carry weights from the JAX package's variable trees into the port.

``jax_variables_to_state_dict`` is the inverse of
``tools/convert_torch_checkpoint.py::convert_state_dict``: it takes the
JAX ``{'params', 'batch_stats'}`` tree (leaves as numpy arrays) and
returns a state dict with the rsiseg key names the port's modules
carry. ``torch_key_to_flax`` is the port's own copy of that tool's key
map (``convert_torch_checkpoint.py:47-151`` and, for the ViT,
``:350-395``; for BEiT, MAE and Swin, of ``transformer_key_to_flax``,
``:290-349`` and ``:394-446``), extended to mmseg's ``avg_down``
downsample (``downsample.{1,2}`` after the pooling layer), the
``MultiLevelNeck`` and the ``UPerHead``. A BEiT's keys share the ViT's
``layers.{i}`` prefix, so the key map of a backbone is chosen by the
family its class declares (``key_family``, read by
``backbone_family``). Swin's patch-merging weights are permuted
between mmseg's ``nn.Unfold`` channel order, which the port keeps, and
the JAX file's position-major order (``convert_torch_checkpoint.py:
267-288``, here in the other direction); mmseg's downsample at the end of
stage i is the JAX file's ``merge_*{i + 1}``.
``discriminator_key_to_flax`` maps ``FCDiscriminator``'s ``conv{i}``
weights (``tests/test_uda_golden_trace.py:1021-1026``).
``load_jax_train_state`` carries a JAX ``UDATrainState`` (or the
adversarial adaptor's ``AdvTrainState``) into the port's train state.
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


def backbone_family(model) -> Optional[str]:
    """The key family that ``model``'s backbone class declares as
    ``key_family`` ('beit' for BEiT and MAE, 'swin'), or None (ResNet,
    ViT, or a model without a backbone)."""
    return getattr(getattr(model, 'backbone', None), 'key_family', None)


def _leaf_name(sub, leaf, names):
    """(name, flax leaf) of an mmseg LayerNorm or Linear ``sub.leaf``
    renamed by ``names``, or None."""
    if sub not in names:
        return None
    leaves = _LN_LEAVES if names[sub].startswith('norm') else _DENSE_LEAVES
    return None if leaf not in leaves else [names[sub], leaves[leaf]]


_BEIT_BLOCK = {'ln1': 'norm1', 'ln2': 'norm2', 'attn.qkv': 'attn/qkv',
               'attn.proj': 'attn/proj', 'ffn.layers.0.0': 'fc1',
               'ffn.layers.1': 'fc2'}


def _beit_key(rest):
    """mmseg BEiT / MAE keys (``convert_torch_checkpoint.py:303-349``)."""
    base = ['backbone_mod']
    if rest[0] in ('pos_embed', 'cls_token'):
        return 'params', base + [rest[0]]
    if rest[:2] == ['patch_embed', 'projection']:
        leaf = _DENSE_LEAVES.get(rest[2])
        return None if leaf is None else ('params',
                                          base + ['patch_embed', leaf])
    if rest[0] == 'ln1':
        leaf = _LN_LEAVES.get(rest[1])
        return None if leaf is None else ('params', base + ['norm1', leaf])
    if rest[0] != 'layers':
        return None
    blk = base + [f'layers_{rest[1]}']
    sub = '.'.join(rest[2:])
    if sub in ('gamma_1', 'gamma_2'):
        return 'params', blk + [sub]
    if sub in ('attn.q_bias', 'attn.v_bias',
               'attn.relative_position_bias_table'):
        return 'params', blk + sub.split('.')
    names = _leaf_name('.'.join(rest[2:-1]), rest[-1], _BEIT_BLOCK)
    return None if names is None else (
        'params', blk + names[0].split('/') + [names[1]])


_SWIN_BLOCK = {'norm1': 'norm1', 'norm2': 'norm2',
               'attn.w_msa.qkv': 'attn/qkv', 'attn.w_msa.proj': 'attn/proj',
               'ffn.layers.0.0': 'fc1', 'ffn.layers.1': 'fc2'}


def _swin_key(rest):
    """mmseg Swin keys (``convert_torch_checkpoint.py:394-446``)."""
    base = ['backbone_mod']
    if rest[0] == 'patch_embed':
        leaves = _DENSE_LEAVES if rest[1] == 'projection' else _LN_LEAVES
        name = {'projection': 'patch_embed', 'norm': 'patch_norm'}.get(
            rest[1])
        return None if name is None or rest[2] not in leaves else (
            'params', base + [name, leaves[rest[2]]])
    m = re.fullmatch(r'norm(\d+)', rest[0])
    if m:
        leaf = _LN_LEAVES.get(rest[1])
        return None if leaf is None else (
            'params', base + [f'out_norm{m.group(1)}', leaf])
    if rest[0] != 'stages':
        return None
    i = int(rest[1])
    if rest[2] == 'downsample':
        if rest[3] == 'norm' and rest[4] in _LN_LEAVES:
            return 'params', base + [f'merge_norm{i + 1}',
                                     _LN_LEAVES[rest[4]]]
        if rest[3:] == ['reduction', 'weight']:
            return 'params', base + [f'merge_reduce{i + 1}', 'kernel']
        return None
    if rest[2] != 'blocks':
        return None
    blk = base + [f'stage{i}_block{rest[3]}']
    sub = '.'.join(rest[4:])
    if sub == 'attn.w_msa.relative_position_bias_table':
        return 'params', blk + ['attn', 'relative_position_bias_table']
    names = _leaf_name('.'.join(rest[4:-1]), rest[-1], _SWIN_BLOCK)
    return None if names is None else (
        'params', blk + names[0].split('/') + [names[1]])


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


def torch_key_to_flax(key: str, ndim: int, uper: bool = False,
                      backbone: Optional[str] = None
                      ) -> Optional[Tuple[str, list]]:
    """Map one rsiseg state-dict key (of a tensor with ``ndim`` dims) to
    ``(collection, path)`` in the JAX tree, or None. ``uper``: the key's
    head is a ``UPerHead`` (whose ``bottleneck`` is the JAX file's
    ``psp_bottleneck``, where other heads keep the name). ``backbone``:
    the model's ``backbone_family``, None for the ResNet and ViT keys."""
    parts = key.split('.')
    if parts[0] == 'backbone':
        if backbone == 'beit':
            return _beit_key(parts[1:])
        if backbone == 'swin':
            return _swin_key(parts[1:])
        return _backbone_key(parts[1:], ndim)
    if parts[0] == 'neck':
        return _neck_key(parts[1:])
    if parts[0] in _HEADS:
        return _head_key(parts[0], parts[1:], uper)
    return None


def discriminator_key_to_flax(key: str) -> Optional[Tuple[str, list]]:
    """``FCDiscriminator``'s ``conv{i}.weight`` / ``.bias`` (OIHW) to the
    JAX module's ``conv{i}/kernel`` (HWIO) / ``bias``, or None."""
    m = re.fullmatch(r'conv(\d+)\.(weight|bias)', key)
    if not m:
        return None
    return 'params', [f'conv{m.group(1)}',
                      'kernel' if m.group(2) == 'weight' else 'bias']


def _leaf(tree, path):
    node = tree
    for k in path:
        if not isinstance(node, Mapping) or k not in node:
            return None
        node = node[k]
    return node


def _official_to_unfold(arr):
    """Swin patch merging's last axis (4C) from the JAX file's
    position-major order ((0,0), (1,0), (0,1), (1,1) windows of C
    channels) to mmseg's ``nn.Unfold`` order (index c * 4 + kh * 2 + kw):
    the inverse of ``convert_torch_checkpoint.py::_unfold_to_official_*``.
    """
    c = arr.shape[-1] // 4
    out = arr.reshape(*arr.shape[:-1], 4, c).swapaxes(-1, -2)
    return out[..., [0, 2, 1, 3]].reshape(*arr.shape[:-1], 4 * c)


def jax_variables_to_state_dict(
        variables: Mapping,
        template: Mapping[str, torch.Tensor],
        backbone: Optional[str] = None) -> dict:
    """JAX ``{'params', 'batch_stats'}`` tree -> port state dict.

    ``template`` is the port model's ``state_dict()``: it names the keys
    to fill and their shapes. Conv kernels go HWIO -> OIHW (depthwise
    ``(3, 3, 1, C)`` -> ``(C, 1, 3, 3)``), Dense kernels (in, out) ->
    (out, in); LayerNorm scales become weights, and ``pos_embed``,
    ``cls_token``, the relative-position tables (entries, heads), q/v
    biases and layer scales carry as they are; Swin's patch-merging norm
    and reduction go to mmseg's unfold order. ``backbone``: the model's
    ``backbone_family``, as ``torch_key_to_flax`` takes it. Raises
    ``KeyError`` naming
    every key of the port that has no source in ``variables``.
    """
    uper = {k.split('.')[0] for k in template if '.fpn_bottleneck.' in k}
    out, missing = {}, []
    for key, ref in template.items():
        if key.endswith('num_batches_tracked'):
            out[key] = torch.zeros_like(ref)
            continue
        mapped = torch_key_to_flax(key, ref.ndim,
                                   uper=key.split('.')[0] in uper,
                                   backbone=backbone) \
            or discriminator_key_to_flax(key)
        leaf = None if mapped is None else _leaf(
            variables.get(mapped[0], {}), mapped[1])
        if leaf is None:
            missing.append(key)
            continue
        arr = np.asarray(leaf, dtype=np.float32)
        if arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        elif arr.ndim == 2 and mapped[1][-1] == 'kernel':
            arr = arr.T                      # Dense (in, out) -> (out, in)
        if mapped[1][-2].startswith(('merge_norm', 'merge_reduce')):
            arr = _official_to_unfold(arr)
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
    ``ema_params``, ``ema_batch_stats``, ``step``, and ``imnet_params``
    where the feature distance is on; leaves as arrays) into the port's
    ``UDATrainState``: the student gets ``params`` and ``batch_stats``,
    the teacher ``ema_params`` and ``ema_batch_stats``, the frozen
    reference ``imnet_params`` (its BN statistics, which its train-mode
    forward never reads, the student's), the adversarial adaptor's
    discriminator ``disc_params``, and ``step`` carries over, with the
    optimizers' LR schedules resumed there. The optimizers' moments do
    not carry over. Raises ``KeyError`` for any key of a module without a
    source."""
    modules = [(state.student, jax_state.params, jax_state.batch_stats)]
    if state.teacher is not None:
        modules.append((state.teacher, jax_state.ema_params,
                        jax_state.ema_batch_stats))
    if getattr(state, 'imnet', None) is not None:
        modules.append((state.imnet, jax_state.imnet_params,
                        jax_state.batch_stats))
    if getattr(state, 'discriminator', None) is not None:
        modules.append((state.discriminator, jax_state.disc_params, {}))
    for module, params, stats in modules:
        ref = module.state_dict()
        sd = jax_variables_to_state_dict(
            {'params': params, 'batch_stats': stats}, ref,
            backbone_family(module))
        module.load_state_dict({k: v.to(ref[k].device)
                                for k, v in sd.items()})
    state.step = int(np.asarray(jax_state.step))
    for opt in (state.optimizer, getattr(state, 'disc_optimizer', None)):
        if opt is not None:
            opt.set_step(state.step)
    return state
