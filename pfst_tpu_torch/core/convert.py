"""Carry weights from the JAX package's variable trees into the port.

``jax_variables_to_state_dict`` is the inverse of
``tools/convert_torch_checkpoint.py::convert_state_dict``: it takes the
JAX ``{'params', 'batch_stats'}`` tree (leaves as numpy arrays) and
returns a state dict with the rsiseg key names the port's modules
carry. ``torch_key_to_flax`` is the port's own copy of that tool's key
map (``convert_torch_checkpoint.py:47-151`` and, for the ViT,
``:350-395``; for BEiT, MAE and Swin, of ``transformer_key_to_flax``,
``:290-349`` and ``:394-446``; for MiT, ``:449-515``), extended to
mmseg's ``avg_down``
downsample (``downsample.{1,2}`` after the pooling layer), the necks
(``MultiLevelNeck``, ``MLANeck``, ``FPN``), the heads, and lists of
auxiliary heads (``auxiliary_head.{i}``, the JAX file's
``aux_heads_{i}``). A BEiT's keys share the ViT's ``layers.{i}`` prefix
and the necks' lists share names, so the key map of a backbone and of a
neck is chosen by the family its class declares (``key_family``, read by
``key_families``). The heads' keys do not collide: where a head follows
mmseg's structure its keys are mmseg's, and where the JAX file departs
from it (SETR-MLA's head, DPT, ANN, Segmenter's missing ``mask_norm``)
they are the JAX file's names. Swin's patch-merging weights are permuted
between mmseg's ``nn.Unfold`` channel order, which the port keeps, and
the JAX file's position-major order (``convert_torch_checkpoint.py:
267-288``, here in the other direction); mmseg's downsample at the end of
stage i is the JAX file's ``merge_*{i + 1}``. MiT's stacked q|k|v
in-projection (mmseg's ``attn.attn.in_proj_*``) is the JAX file's three
Dense layers ``q``, ``k``, ``v`` concatenated (a path element ``q|k|v``),
and its Mix-FFN's 1x1 convs ``ffn.layers.{0,4}`` are the JAX file's
Dense ``fc1``, ``fc2``; Twins, which the JAX tool does not map, keeps the
JAX file's names for its own modules and MiT's inside them, and so do
the CNN backbones and ``ICNeck`` (the ``cnn`` family: UNet, HRNet,
ConvNeXt, the MobileNets and the real-time nets), with mmcv's
``ConvModule`` names and the port's ResNet names inside (``_cnn_key``).
An ``LRASPPHead`` (told by its ``conv_up``) keeps the JAX file's names
too, its classifier directly ``conv_seg``. So do the attention and context
heads of DANet, NL, DNL, GCNet, APCNet, DMNet, EMANet, ISANet, CCNet,
PSANet and EncNet for their own modules (``_JAX_NAMED_HEAD``), mapped as
the ``cnn`` family maps a module, with their scalar ``gamma``s, EMANet's
``bases`` (a ``batch_stats`` leaf) and the encoding's ``codewords`` and
``scale``; their ``bottleneck`` and ``conv_seg`` are mmseg's. The
stages of a cascade's ``decode_head`` list (``decode_head.{i}``, mmseg's
layout) are the JAX file's ``stage_heads_{i}``; OCR's, PointRend's and
K-Net's modules keep the JAX file's names (``query``, ``key``,
``value``, ``fuse``, ``soft_regions``; ``fc{i}``, ``point_cls``,
``coarse_conv``, ``coarse_cls``; ``kgh``, a head of its own, and
``update_head{i}`` with its layers inside). A
``SegformerHead`` (told by its ``fusion_conv``) maps mmseg's ``convs.{i}``
to the JAX file's ``proj{i}``, where an FCN head's are ``conv{i}``.
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


def _backbone_key(rest, ndim, base=('backbone_mod',)):
    """A ResNet key (or a ViT's), its JAX path under ``base``."""
    if rest[0] in ('pos_embed', 'cls_token', 'patch_embed', 'layers', 'ln1'):
        return _vit_key(rest)
    base = list(base)
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
    if sub == 'conv2' and len(rest) > 4:
        # ResNeSt's split-attention conv, the JAX file's names inside
        return _cnn_key(rest[3:], ndim, blk + ['conv2'])
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


def _leaf_of(leaf, ndim):
    """flax's leaf for a torch ``weight`` (a kernel, or a LayerNorm's
    scale where 1-D) or ``bias``."""
    if leaf == 'bias':
        return 'bias'
    return None if leaf != 'weight' else ('kernel' if ndim > 1 else 'scale')


# MiT's and Twins' block modules (mmseg's names, inside the blocks of both
# families) to the JAX file's
_MIT_BLOCK = {'norm1': ['norm1'], 'norm2': ['norm2'],
              'attn.attn.out_proj': ['attn', 'proj'], 'attn.sr': ['attn', 'sr'],
              'attn.norm': ['attn', 'sr_norm'], 'attn.qkv': ['attn', 'qkv'],
              'attn.proj': ['attn', 'proj'],
              'ffn.layers.0': ['ffn', 'fc1'], 'ffn.layers.1': ['ffn', 'dwconv'],
              'ffn.layers.4': ['ffn', 'fc2']}


def _mit_block_key(r, path, ndim):
    """A key ``r`` inside a MiT or Twins block at JAX ``path``: the stacked
    in-projection to ``q|k|v`` (three Dense layers, concatenated)."""
    sub, leaf = '.'.join(r[:-1]), r[-1]
    if sub == 'attn.attn' and leaf in ('in_proj_weight', 'in_proj_bias'):
        return 'params', path + ['attn', 'q|k|v', 'kernel'
                                 if leaf.endswith('weight') else 'bias']
    name, flax_leaf = _MIT_BLOCK.get(sub), _leaf_of(leaf, ndim)
    return None if name is None or flax_leaf is None else (
        'params', path + name + [flax_leaf])


def _mit_key(rest, ndim):
    """mmseg MiT keys (``convert_torch_checkpoint.py:449-515``):
    ``layers.{i}.0`` the patch embedding, ``.1.{j}`` the blocks, ``.2``
    the stage norm."""
    base = ['backbone_mod']
    if rest[0] != 'layers' or len(rest) < 4:
        return None
    i, part = rest[1], rest[2]
    if part == '0' and rest[3] in ('projection', 'norm') and len(rest) == 5:
        name = 'patch_embed' if rest[3] == 'projection' else 'embed_norm'
        leaf = _leaf_of(rest[4], ndim)
        return None if leaf is None else ('params',
                                          base + [f'{name}{i}', leaf])
    if part == '2' and len(rest) == 4:
        leaf = _leaf_of(rest[3], ndim)
        return None if leaf is None else ('params',
                                          base + [f'stage_norm{i}', leaf])
    if part == '1' and len(rest) > 4:
        return _mit_block_key(rest[4:], base + [f'stage{i}_block{rest[3]}'],
                              ndim)
    return None


def _twins_key(rest, ndim):
    """Twins keys: the JAX file's own names (``patch_embed{i}``,
    ``embed_norm{i}``, ``peg{i}.proj``, ``s{i}_b{j}``), MiT's inside the
    blocks."""
    base = ['backbone_mod']
    if re.fullmatch(r's\d+_b\d+', rest[0]):
        return _mit_block_key(rest[1:], base + [rest[0]], ndim)
    leaf = _leaf_of(rest[-1], ndim)
    if leaf is None or not (
            re.fullmatch(r'(patch_embed|embed_norm)\d+', rest[0])
            and len(rest) == 2
            or re.fullmatch(r'peg\d+', rest[0]) and rest[1:-1] == ['proj']):
        return None
    return 'params', base + rest[:-1] + [leaf]


_NORMS = ('bn', 'gn', 'ln', 'in')
_STATS = {'running_mean': 'mean', 'running_var': 'var'}


def _cnn_leaf(mods, leaf, ndim):
    """(collection, path) of ``leaf`` of the module at JAX path ``mods``:
    a norm's scale, shift and statistics, a kernel, bias or ``gamma``."""
    if leaf in _STATS:
        return 'batch_stats', mods + [_STATS[leaf]]
    if leaf == 'weight':
        return 'params', mods + ['kernel' if ndim > 1 else 'scale']
    if leaf in ('bias', 'gamma'):
        return 'params', mods + [leaf]
    return None


def _cnn_key(rest, ndim, base):
    """The ``cnn`` family: the CNN backbones and necks whose modules have
    the JAX file's names (UNet, HRNet, ConvNeXt, the MobileNets, the
    real-time nets, ``ICNeck``), with three kinds of module inside that
    keep the port's names:

    * mmcv's ``ConvModule``: ``X.bn.*`` is the JAX ``X/norm/bn/*``, unless
      ``X`` is itself a norm name: then it is the JAX file's standalone
      ``Norm`` module, whose ``X/bn/*`` carries as it is (CGNet);
    * the port's ResNet blocks (HRNet's): ``B.conv{k}`` and ``B.bn{k}`` are
      the JAX ``B/conv{k}/conv`` and ``B/conv{k}/norm/bn``,
      ``B.downsample.{0,1}`` the JAX ``B/downsample/conv/{conv,norm/bn}``;
    * a sub-backbone under flax's auto-name (``ResNet_0``, ``ResNetV1c_0``)
      with the ResNet keys inside, and ICNet's ``PPM``, whose branch
      ``psp.{j}.1`` is the JAX ``psp/pool{j}``.
    """
    mods, leaf = list(rest[:-1]), rest[-1]
    for i, part in enumerate(mods):
        if re.fullmatch(r'ResNet(V1[cd])?_\d+', part):
            return _backbone_key(rest[i + 1:], ndim, base + rest[:i + 1])
        if part == 'psp' and mods[i + 2:i + 3] == ['1']:
            mods[i + 1:i + 3] = [f'pool{mods[i + 1]}']
            break
    path = base + mods
    if len(mods) >= 2 and mods[-1] == '1' and mods[-2] == 'downsample':
        return _cnn_leaf(path[:-1] + ['conv', 'norm', 'bn'], leaf, ndim)
    if len(mods) >= 2 and mods[-1] == '0' and mods[-2] == 'downsample':
        return None if leaf != 'weight' else (
            'params', path[:-1] + ['conv', 'conv', 'kernel'])
    if re.fullmatch(r'conv\d+', mods[-1]) and leaf == 'weight':
        return 'params', path + ['conv', 'kernel']
    m = re.fullmatch(r'bn(\d+)', mods[-1])
    if m:
        return _cnn_leaf(path[:-1] + [f'conv{m.group(1)}', 'norm', 'bn'],
                         leaf, ndim)
    if mods[-1] in _NORMS and not (len(mods) >= 2 and mods[-2] in _NORMS):
        return _cnn_leaf(path[:-1] + ['norm', mods[-1]], leaf, ndim)
    return _cnn_leaf(path, leaf, ndim)


def _conv_module(rest, path):
    """mmcv ConvModule: conv.weight/bias, bn.*; DepthwiseSeparable
    nests two of them."""
    if rest[0] == 'conv':
        leaf = {'weight': 'kernel', 'bias': 'bias'}.get(rest[1])
        return None if leaf is None else (
            'params', path + ['conv', leaf])
    if rest[0] == 'bn':
        return _bn(rest[1], path)
    if rest[0] == 'ln':
        leaf = _LN_LEAVES.get(rest[1])
        return None if leaf is None else (
            'params', path + ['norm', 'ln', leaf])
    if rest[0] in ('depthwise_conv', 'pointwise_conv'):
        return _conv_module(rest[1:], path + [rest[0]])
    return None


_HEADS = {'decode_head': 'decode_head_mod', 'auxiliary_head': 'aux_heads'}
# the neck key maps, by the family the neck's class declares: its
# ModuleLists' names to the JAX file's ``{name}{i}`` prefixes
_NECKS = {'multilevel': {'lateral_convs': 'lateral', 'convs': 'conv'},
          'mla': {'lateral': 'lateral', 'conv': 'conv'},
          'fpn': {'lateral_convs': 'lateral', 'fpn_convs': 'fpn_conv'}}
# heads whose ModuleLists keep the JAX file's ``{name}{i}`` names:
# SETR-MLA's and DPT's
_JAX_NAMED_LISTS = ('mla_conv', 'reassemble', 'project', 'fuse')
# Segmenter's mmseg names to the JAX file's; its decoder layers are the
# ViT's blocks, whose names (``_VIT_BLOCK``) the JAX file suffixes ``_{i}``
_SEGMENTER = {'dec_proj': 'proj_in', 'decoder_norm': 'norm_out',
              'patch_proj': 'patch_proj', 'classes_proj': 'cls_proj'}


def key_families(model) -> dict:
    """The key families that ``model``'s backbone and neck classes declare
    (``key_family``), as the keyword arguments ``backbone`` and ``neck``
    of ``torch_key_to_flax`` and ``jax_variables_to_state_dict``; a part
    without a declared family is left out."""
    out = {}
    for part in ('backbone', 'neck'):
        family = getattr(getattr(model, part, None), 'key_family', None)
        if family is not None:
            out[part] = family
    return out


def _neck_key(r, neck, ndim):
    """A neck's ``{list}.{i}`` ConvModules by its family's map. Raises
    ``ValueError`` without a family: the necks' list names collide."""
    if neck is None:
        raise ValueError(f'neck key neck.{".".join(r)} without the neck\'s '
                         'family: pass **key_families(model)')
    if neck == 'cnn':
        return _cnn_key(r, ndim, ['neck_mod'])
    name = _NECKS[neck].get(r[0])
    return None if name is None or len(r) < 3 else _conv_module(
        r[2:], ['neck_mod', f'{name}{r[1]}'])


def _dense(leaf, path):
    leaf = _DENSE_LEAVES.get(leaf)
    return None if leaf is None else ('params', path + [leaf])


def _segmenter_key(r, base):
    if r == ['cls_emb']:
        return 'params', base + ['cls_emb']
    if r[0] in _SEGMENTER and len(r) == 2:
        name = _SEGMENTER[r[0]]
        leaves = _LN_LEAVES if name.startswith('norm') else _DENSE_LEAVES
        return None if r[1] not in leaves else (
            'params', base + [name, leaves[r[1]]])
    if r[0] != 'layers':
        return None
    sub, leaf = '.'.join(r[2:-1]), r[-1]
    if sub == 'attn.attn' and leaf in ('in_proj_weight', 'in_proj_bias'):
        return 'params', base + [f'qkv_{r[1]}', 'kernel'
                                 if leaf.endswith('weight') else 'bias']
    names = _leaf_name(sub, leaf, _VIT_BLOCK)
    return None if names is None else (
        'params', base + [f'{names[0]}_{r[1]}', names[1]])


# the attention and context heads' own modules, which keep the JAX file's
# names (``attention_heads.py``, ``context_heads.py``, ``isa_cc_heads.py``,
# ``enc_head.py``)
_JAX_NAMED_HEAD = re.compile(
    r'(pam|cam)(_in|_out|_cls)?|conv_in|theta|phi|g|conv_out_nl|unary|'
    r'context_mask|transform(1|2|_ln)|pool_proj\d+|query\d+|ema_(in|out)|'
    r'global|local|(query|key|value)_conv|reduce(_p)?|'
    r'attention(_p)?_(conv|mask)|proj|fc|se_layer|'
    # OCR's, PointRend's, and K-Net's stages (``point_rend.py``)
    r'query|key|value|soft_regions|fc\d+|point_cls|coarse_(conv|cls)|'
    r'update_head\d+')


def _head_key(base, r, ndim, uper=False, segformer=False, lraspp=False):
    if _JAX_NAMED_HEAD.fullmatch(r[0]) and len(r) > 1:
        return _cnn_key(r, ndim, base)
    if r[0] == 'kgh':
        # K-Net's kernel-generate head, a head of its own
        return _head_key(base + ['kgh'], r[1:], ndim)
    if r[0] == 'fuse' and not r[1].isdigit():
        # OCR's fusion ConvModule (DPT's are a list, ``fuse.{i}``)
        return _conv_module(r[1:], base + ['fuse'])
    if r in (['gamma'], ['encoding', 'codewords'], ['encoding', 'scale']):
        return 'params', base + r
    if r == ['bases']:
        return 'batch_stats', base + r
    if segformer and r[0] in ('convs', 'fusion_conv'):
        # SegformerHead: mmseg's names to the JAX file's
        return _conv_module(r[2:], base + [f'proj{r[1]}']) \
            if r[0] == 'convs' else _conv_module(r[1:], base + ['fusion'])
    if uper:
        # UPerHead: mmseg's names to the JAX file's
        if r[0] in ('lateral_convs', 'fpn_convs'):
            name = 'lateral' if r[0] == 'lateral_convs' else 'fpn_conv'
            return _conv_module(r[2:], base + [f'{name}{r[1]}'])
        if r[0] in ('bottleneck', 'fpn_bottleneck'):
            name = 'psp_bottleneck' if r[0] == 'bottleneck' else r[0]
            return _conv_module(r[1:], base + [name])
    if r[0] == 'psp_modules':
        # PPM branch j: Sequential(adaptive pool, ConvModule)
        return _conv_module(r[3:], base + ['ppm', f'pool{r[1]}'])
    if r[0] == 'image_pool':
        # Sequential(AdaptiveAvgPool2d, ConvModule)
        return _conv_module(r[2:], base + ['image_pool_conv'])
    if r[0] == 'aspp_modules':
        return _conv_module(r[2:], base + ['aspp_modules', f'branch{r[1]}'])
    if r[0] in ('bottleneck', 'c1_bottleneck', 'conv_cat', 'high_in',
                'out_proj', 'head_conv', 'conv_up'):
        return _conv_module(r[1:], base + [r[0]])
    if r[0] == 'image_pool_conv' and len(r) == 2:
        # LRASPPHead's plain 1x1 conv
        return _dense(r[1], base + [r[0]])
    if r[0] == 'lateral' and len(r) == 3:
        # LRASPPHead's plain 1x1 convs
        return _dense(r[2], base + [f'lateral{r[1]}'])
    if r[0] == 'sep_bottleneck':
        return _conv_module(r[2:], base + [f'sep_bottleneck{int(r[1]) + 1}'])
    if r[0] == 'convs':
        return _conv_module(r[2:], base + [f'conv{r[1]}'])
    if r[0] in _JAX_NAMED_LISTS:
        return _conv_module(r[2:], base + [f'{r[0]}{r[1]}'])
    if r[0] == 'up_convs':
        # SETRUPHead: Sequential(ConvModule, Upsample)
        return _conv_module(r[3:], base + [f'up_conv{r[1]}'])
    if r[0] == 'scale_heads':
        # FPNHead level i: ConvModules, each but level 0's followed by an
        # upsampling
        i, k = int(r[1]), int(r[2])
        return _conv_module(r[3:], base + [
            f'scale{i}_conv{k if i == 0 else k // 2}'])
    if r[0] == 'norm' and len(r) == 2:
        leaf = _LN_LEAVES.get(r[1])
        return None if leaf is None else ('params', base + ['norm', leaf])
    if r[0] == 'q' and len(r) == 2:
        # ANNHead's 1x1 query conv
        leaf = {'weight': 'kernel', 'bias': 'bias'}.get(r[1])
        return None if leaf is None else ('params', base + ['q', leaf])
    if r[0] in ('k', 'v') and len(r) == 2:
        return _dense(r[1], base + [r[0]])
    if r[0] == 'conv_seg':
        # under the JAX file's ``ClsSeg``, but LRASPPHead's is its own
        return _dense(r[1], base + ([] if lraspp else ['cls']) + ['conv_seg'])
    return _segmenter_key(r, base)


def _head_prefix(parts):
    """(the head's key prefix, its JAX module name, the rest of the key):
    ``auxiliary_head.{i}`` of a list of auxiliary heads is the JAX
    file's ``aux_heads_{i}``, a single one ``aux_heads_0``; stage i of a
    cascade's ``decode_head`` list is ``stage_heads_{i}``."""
    if parts[1].isdigit():
        name = 'aux_heads' if parts[0] == 'auxiliary_head' else 'stage_heads'
        return f'{parts[0]}.{parts[1]}', f'{name}_{parts[1]}', parts[2:]
    if parts[0] == 'auxiliary_head':
        return 'auxiliary_head', 'aux_heads_0', parts[1:]
    return parts[0], _HEADS[parts[0]], parts[1:]


def torch_key_to_flax(key: str, ndim: int, uper: bool = False,
                      backbone: Optional[str] = None,
                      neck: Optional[str] = None, segformer: bool = False,
                      lraspp: bool = False) -> Optional[Tuple[str, list]]:
    """Map one rsiseg state-dict key (of a tensor with ``ndim`` dims) to
    ``(collection, path)`` in the JAX tree, or None. ``uper``: the key's
    head is a ``UPerHead`` (whose ``bottleneck`` is the JAX file's
    ``psp_bottleneck``, where other heads keep the name); ``segformer``: a
    ``SegformerHead`` (whose ``convs`` are the JAX file's ``proj``);
    ``lraspp``: an ``LRASPPHead`` (whose ``conv_seg`` is the JAX file's
    own, not ``ClsSeg``'s).
    ``backbone``, ``neck``: the families of ``key_families``
    (``backbone`` None for the ResNet and ViT keys); a neck key needs its
    family. A path element ``a|b|c`` names leaves concatenated on their
    last axis."""
    parts = key.split('.')
    if parts[0] == 'backbone' and (backbone or '').startswith('timm:'):
        # TIMMBackbone: the inner backbone's keys under ``inner``
        if parts[1] != 'inner':
            return None
        mapped = torch_key_to_flax('.'.join(['backbone'] + parts[2:]), ndim,
                                   backbone=backbone[5:] or None)
        return None if mapped is None else (
            mapped[0], mapped[1][:1] + ['inner'] + mapped[1][1:])
    if parts[0] == 'backbone':
        family = {'beit': _beit_key, 'swin': _swin_key}.get(backbone)
        if family is not None:
            return family(parts[1:])
        if backbone == 'cnn':
            return _cnn_key(parts[1:], ndim, ['backbone_mod'])
        family = {'mit': _mit_key, 'twins': _twins_key}.get(
            backbone, _backbone_key)
        return family(parts[1:], ndim)
    if parts[0] == 'neck':
        return _neck_key(parts[1:], neck, ndim)
    if parts[0] in _HEADS:
        _, name, rest = _head_prefix(parts)
        return _head_key([name], rest, ndim, uper, segformer, lraspp)
    return None


def head_prefix(key: str) -> Optional[str]:
    """The prefix of the head that holds ``key`` (``decode_head``,
    ``auxiliary_head`` or ``auxiliary_head.{i}``), or None."""
    parts = key.split('.')
    return _head_prefix(parts)[0] if parts[0] in _HEADS else None


def uper_heads(keys) -> set:
    """The prefixes of the ``UPerHead``s among ``keys``: the heads with an
    ``fpn_bottleneck``."""
    return {head_prefix(k) for k in keys if '.fpn_bottleneck.' in k}


def segformer_heads(keys) -> set:
    """The prefixes of the ``SegformerHead``s among ``keys``: the heads
    with a ``fusion_conv``."""
    return {head_prefix(k) for k in keys if '.fusion_conv.' in k}


def lraspp_heads(keys) -> set:
    """The prefixes of the ``LRASPPHead``s among ``keys``: the heads with
    a ``conv_up``."""
    return {head_prefix(k) for k in keys if '.conv_up.' in k}


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
    for i, k in enumerate(path):
        if '|' in k:    # leaves concatenated on their last axis (q|k|v)
            parts = [_leaf(node, [a, *path[i + 1:]]) for a in k.split('|')]
            return None if any(p is None for p in parts) else \
                np.concatenate([np.asarray(p) for p in parts], axis=-1)
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
        backbone: Optional[str] = None,
        neck: Optional[str] = None) -> dict:
    """JAX ``{'params', 'batch_stats'}`` tree -> port state dict.

    ``template`` is the port model's ``state_dict()``: it names the keys
    to fill and their shapes. Conv kernels go HWIO -> OIHW (depthwise
    ``(3, 3, 1, C)`` -> ``(C, 1, 3, 3)``), Dense kernels (in, out) ->
    (out, in), or (out, in, 1, 1) where the port holds a 1x1 conv (MiT's
    Mix-FFN); MiT's q, k, v kernels and biases are stacked into one
    in-projection; LayerNorm scales become weights, and ``pos_embed``,
    ``cls_token``, the relative-position tables (entries, heads), q/v
    biases and layer scales carry as they are; Swin's patch-merging norm
    and reduction go to mmseg's unfold order. ``backbone``, ``neck``: the
    model's ``key_families``, as ``torch_key_to_flax`` takes them. Raises
    ``KeyError`` naming
    every key of the port that has no source in ``variables``.
    """
    uper, segformer = uper_heads(template), segformer_heads(template)
    lraspp = lraspp_heads(template)
    out, missing = {}, []
    for key, ref in template.items():
        if key.endswith('num_batches_tracked'):
            out[key] = torch.zeros_like(ref)
            continue
        mapped = torch_key_to_flax(key, ref.ndim,
                                   uper=head_prefix(key) in uper,
                                   backbone=backbone, neck=neck,
                                   segformer=head_prefix(key) in segformer,
                                   lraspp=head_prefix(key) in lraspp) \
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
            if ref.ndim == 4:
                arr = arr[:, :, None, None]  # as a 1x1 conv
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
            **key_families(module))
        module.load_state_dict({k: v.to(ref[k].device)
                                for k, v in sd.items()})
    state.step = int(np.asarray(jax_state.step))
    for opt in (state.optimizer, getattr(state, 'disc_optimizer', None)):
        if opt is not None:
            opt.set_step(state.step)
    return state
