"""HRNet backbone on NCHW tensors (port of
``pfst_tpu/models/backbones/hrnet.py``).

Parallel multi-resolution branches with repeated fusion, built from the
mmseg ``extra`` stage config (``num_modules``, ``num_branches``,
``block``, ``num_blocks``, ``num_channels`` per stage) with the port's
ResNet ``BasicBlock`` and ``Bottleneck``. The JAX file's rules:

* a block takes a downsample where it is the first of its branch and its
  input's width is not the branch's (stage 1: every first block);
* a stage's transition convs only a branch whose width changes (3x3), or
  a new branch (3x3 stride 2 from the previous stage's last branch);
* the fuse into branch i: from a lower-resolution branch j a 1x1 conv
  without activation, then a bilinear resize; from a higher-resolution
  one ``i - j`` stride-2 3x3 convs, the last without activation; a ReLU
  after the sum.

Module names are the JAX file's (``stem1``, ``layer1_block{i}``,
``stage{n}_trans{b}``, ``stage{n}_module{m}.branch{b}_block{i}``,
``fuse{i}_{j}[_down{s}]``); the blocks keep the port's ResNet names
inside, all mapped by ``core.convert``'s ``cnn`` family.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch.nn as nn
import torch.nn.functional as F

from ...ops import resize
from ..builder import BACKBONES
from ..utils.layers import ConvModule, NormEvalModule
from .resnet import BasicBlock, Bottleneck

HRNET18_EXTRA = dict(
    stage1=dict(num_modules=1, num_branches=1, block='BOTTLENECK',
                num_blocks=(4,), num_channels=(64,)),
    stage2=dict(num_modules=1, num_branches=2, block='BASIC',
                num_blocks=(4, 4), num_channels=(18, 36)),
    stage3=dict(num_modules=4, num_branches=3, block='BASIC',
                num_blocks=(4, 4, 4), num_channels=(18, 36, 72)),
    stage4=dict(num_modules=3, num_branches=4, block='BASIC',
                num_blocks=(4, 4, 4, 4),
                num_channels=(18, 36, 72, 144)))

_BLOCKS = {'BASIC': BasicBlock, 'BOTTLENECK': Bottleneck}
_NO_ACT = {'type': 'none'}


class HRModule(nn.Module):

    def __init__(self, num_branches: int, block: str,
                 num_blocks: Sequence[int], in_channels: Sequence[int],
                 num_channels: Sequence[int], norm_cfg: Optional[dict] = None):
        super().__init__()
        block_cls = _BLOCKS[block]
        self.num_branches = num_branches
        chans = [c * block_cls.expansion for c in num_channels]
        for b in range(num_branches):
            cin = in_channels[b]
            for i in range(num_blocks[b]):
                self.add_module(f'branch{b}_block{i}', block_cls(
                    cin, num_channels[b],
                    with_downsample=cin != chans[b] and i == 0,
                    norm_cfg=norm_cfg))
                cin = chans[b]
        self.num_blocks = tuple(num_blocks)
        for i in range(num_branches):
            for j in range(num_branches):
                if j > i:
                    self.add_module(f'fuse{i}_{j}', ConvModule(
                        chans[j], chans[i], 1, norm_cfg=norm_cfg,
                        act_cfg=_NO_ACT))
                for s in range(i - j):
                    last = s == i - j - 1
                    self.add_module(f'fuse{i}_{j}_down{s}', ConvModule(
                        chans[j], chans[i] if last else chans[j], 3,
                        stride=2, padding=1, norm_cfg=norm_cfg,
                        act_cfg=_NO_ACT if last else None))

    def forward(self, xs):
        outs = []
        for b in range(self.num_branches):
            x = xs[b]
            for i in range(self.num_blocks[b]):
                x = getattr(self, f'branch{b}_block{i}')(x)
            outs.append(x)
        fused = []
        for i in range(self.num_branches):
            acc = None
            for j, y in enumerate(outs):
                if j > i:
                    y = resize(getattr(self, f'fuse{i}_{j}')(y),
                               size=outs[i].shape[2:], mode='bilinear',
                               align_corners=False)
                for s in range(i - j):
                    y = getattr(self, f'fuse{i}_{j}_down{s}')(y)
                acc = y if acc is None else acc + y
            fused.append(F.relu(acc))
        return fused


@BACKBONES.register_module()
class HRNet(NormEvalModule):

    key_family = 'cnn'      # core.convert's key map

    def __init__(self,
                 extra: Optional[dict] = None,
                 in_channels: int = 3,
                 norm_cfg: Optional[dict] = None,
                 norm_eval: bool = False,
                 frozen_stages: int = -1,
                 pretrained: Optional[str] = None,
                 init_cfg: Optional[dict] = None):
        super().__init__()
        # frozen_stages is accepted and unused, as in the JAX file
        del frozen_stages, pretrained, init_cfg
        extra = {k: dict(v) for k, v in (extra or HRNET18_EXTRA).items()}
        self.norm_eval = norm_eval
        self.stem1 = ConvModule(in_channels, 64, 3, stride=2, padding=1,
                                norm_cfg=norm_cfg)
        self.stem2 = ConvModule(64, 64, 3, stride=2, padding=1,
                                norm_cfg=norm_cfg)
        s1 = extra['stage1']
        block_cls = _BLOCKS[s1['block']]
        cin = 64
        self.n_layer1 = s1['num_blocks'][0]
        for i in range(self.n_layer1):
            self.add_module(f'layer1_block{i}', block_cls(
                cin, s1['num_channels'][0], with_downsample=i == 0,
                norm_cfg=norm_cfg))
            cin = s1['num_channels'][0] * block_cls.expansion
        chans = [cin]
        self.stages = []
        for name in ('stage2', 'stage3', 'stage4'):
            cfg = extra[name]
            nb = cfg['num_branches']
            expansion = _BLOCKS[cfg['block']].expansion
            trans = []
            for b in range(nb):
                target = cfg['num_channels'][b] * expansion
                if b >= len(chans) or chans[b] != target:
                    new = b >= len(chans)
                    self.add_module(f'{name}_trans{b}', ConvModule(
                        chans[-1] if new else chans[b], target, 3,
                        stride=2 if new else 1, padding=1,
                        norm_cfg=norm_cfg))
                    trans.append(f'{name}_trans{b}')
                else:
                    trans.append(None)
            chans = [cfg['num_channels'][b] * expansion for b in range(nb)]
            modules = []
            for m in range(cfg['num_modules']):
                self.add_module(f'{name}_module{m}', HRModule(
                    nb, cfg['block'], cfg['num_blocks'], chans,
                    cfg['num_channels'], norm_cfg))
                modules.append(f'{name}_module{m}')
            self.stages.append((trans, modules))
        self.feature_channels = tuple(chans)

    def forward(self, x):
        x = self.stem2(self.stem1(x))
        for i in range(self.n_layer1):
            x = getattr(self, f'layer1_block{i}')(x)
        xs = [x]
        for trans, modules in self.stages:
            xs = [xs[b] if t is None else
                  getattr(self, t)(xs[b] if b < len(xs) else xs[-1])
                  for b, t in enumerate(trans)]
            for m in modules:
                xs = getattr(self, m)(xs)
        return tuple(xs)
