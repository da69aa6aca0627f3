"""MobileNetV2 / V3 backbones on NCHW tensors (port of
``pfst_tpu/models/backbones/mobilenet.py``).

``InvertedResidual``: a 1x1 expansion (but at ratio 1), a depthwise 3x3
carrying the stride and dilation, an optional squeeze-and-excite gate, a
1x1 projection without activation, and the residual where the stride is 1
and the width kept; BiSeNetV2 and Fast-SCNN build on it. ``MobileNetV3``
inlines the same block with its per-layer kernel, SE and activation.
Where the JAX file departs from mmseg this port follows it: the SE
squeeze width is ``max(exp // 4, 8)`` (mmseg's ``make_divisible``), its
two 1x1 convs carry a bias, and its gate is ``hard_sigmoid``,
``relu6(x + 3) / 6``; no layer is dilated, so MobileNetV3's
``out_indices`` (1, 3, 16) are at strides 2, 4 and 32. Module names are
the JAX file's (``stem``, ``layer{i}_block{j}.{expand,depthwise,
se_reduce,se_expand,project}``, ``b{i}_{expand,dw,se1,se2,project}``,
``final``), mapped by ``core.convert``'s ``cnn`` family.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch.nn as nn
import torch.nn.functional as F

from ..builder import BACKBONES
from ..utils.layers import ConvModule, NormEvalModule

_NO_ACT = {'type': 'none'}


def _se_width(exp: int) -> int:
    return max(exp // 4, 8)


def _se_gate(x, reduce, expand):
    s = x.mean(dim=(2, 3), keepdim=True)
    return x * F.hardsigmoid(expand(F.relu(reduce(s))))


class InvertedResidual(nn.Module):

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 expand_ratio: int = 6, dilation: int = 1,
                 with_se: bool = False, act: str = 'ReLU6',
                 norm_cfg: Optional[dict] = None):
        super().__init__()
        hidden = int(round(in_channels * expand_ratio))
        act_cfg = {'type': act}
        self.use_res = stride == 1 and in_channels == out_channels
        self.expand = ConvModule(in_channels, hidden, 1, norm_cfg=norm_cfg,
                                 act_cfg=act_cfg) \
            if expand_ratio != 1 else None
        self.depthwise = ConvModule(hidden, hidden, 3, stride=stride,
                                    padding=dilation, dilation=dilation,
                                    groups=hidden, norm_cfg=norm_cfg,
                                    act_cfg=act_cfg)
        if with_se:
            self.se_reduce = nn.Conv2d(hidden, _se_width(hidden), 1)
            self.se_expand = nn.Conv2d(_se_width(hidden), hidden, 1)
        self.with_se = with_se
        self.project = ConvModule(hidden, out_channels, 1, norm_cfg=norm_cfg,
                                  act_cfg=_NO_ACT)

    def forward(self, x):
        out = x if self.expand is None else self.expand(x)
        out = self.depthwise(out)
        if self.with_se:
            out = _se_gate(out, self.se_reduce, self.se_expand)
        out = self.project(out)
        return out + x if self.use_res else out


@BACKBONES.register_module()
class MobileNetV2(NormEvalModule):

    key_family = 'cnn'      # core.convert's key map
    # (expand_ratio, channel, num_blocks) per stage, MobileNetV2 paper
    arch = [(1, 16, 1), (6, 24, 2), (6, 32, 3), (6, 64, 4), (6, 96, 3),
            (6, 160, 3), (6, 320, 1)]

    def __init__(self,
                 in_channels: int = 3,
                 widen_factor: float = 1.0,
                 strides: Sequence[int] = (1, 2, 2, 2, 1, 2, 1),
                 dilations: Sequence[int] = (1, 1, 1, 1, 1, 1, 1),
                 out_indices: Sequence[int] = (1, 2, 4, 6),
                 frozen_stages: int = -1,
                 norm_cfg: Optional[dict] = None,
                 norm_eval: bool = False,
                 pretrained: Optional[str] = None,
                 init_cfg: Optional[dict] = None):
        super().__init__()
        # frozen_stages is accepted and unused, as in the JAX file
        del frozen_stages, pretrained, init_cfg
        self.norm_eval = norm_eval
        self.out_indices = tuple(out_indices)
        ch = int(32 * widen_factor)
        self.stem = ConvModule(in_channels, ch, 3, stride=2, padding=1,
                               norm_cfg=norm_cfg, act_cfg={'type': 'ReLU6'})
        self.stages, chans = [], []
        for i, (er, c, n) in enumerate(self.arch):
            out_ch = int(c * widen_factor)
            names = []
            for b in range(n):
                self.add_module(f'layer{i + 1}_block{b}', InvertedResidual(
                    ch, out_ch, stride=strides[i] if b == 0 else 1,
                    expand_ratio=er, dilation=dilations[i],
                    norm_cfg=norm_cfg))
                names.append(f'layer{i + 1}_block{b}')
                ch = out_ch
            self.stages.append(names)
            if i in self.out_indices:
                chans.append(ch)
        self.feature_channels = tuple(chans)

    def forward(self, x):
        x = self.stem(x)
        outs = []
        for i, names in enumerate(self.stages):
            for name in names:
                x = getattr(self, name)(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)


@BACKBONES.register_module()
class MobileNetV3(NormEvalModule):
    """MobileNetV3-large/small with SE and hard-swish blocks."""

    key_family = 'cnn'      # core.convert's key map
    # (kernel, expand_ch, out_ch, se, act, stride)
    settings = {
        'small': [(3, 16, 16, True, 'ReLU', 2),
                  (3, 72, 24, False, 'ReLU', 2),
                  (3, 88, 24, False, 'ReLU', 1),
                  (5, 96, 40, True, 'HSwish', 2),
                  (5, 240, 40, True, 'HSwish', 1),
                  (5, 240, 40, True, 'HSwish', 1),
                  (5, 120, 48, True, 'HSwish', 1),
                  (5, 144, 48, True, 'HSwish', 1),
                  (5, 288, 96, True, 'HSwish', 2),
                  (5, 576, 96, True, 'HSwish', 1),
                  (5, 576, 96, True, 'HSwish', 1)],
        'large': [(3, 16, 16, False, 'ReLU', 1),
                  (3, 64, 24, False, 'ReLU', 2),
                  (3, 72, 24, False, 'ReLU', 1),
                  (5, 72, 40, True, 'ReLU', 2),
                  (5, 120, 40, True, 'ReLU', 1),
                  (5, 120, 40, True, 'ReLU', 1),
                  (3, 240, 80, False, 'HSwish', 2),
                  (3, 200, 80, False, 'HSwish', 1),
                  (3, 184, 80, False, 'HSwish', 1),
                  (3, 184, 80, False, 'HSwish', 1),
                  (3, 480, 112, True, 'HSwish', 1),
                  (3, 672, 112, True, 'HSwish', 1),
                  (5, 672, 160, True, 'HSwish', 2),
                  (5, 960, 160, True, 'HSwish', 1),
                  (5, 960, 160, True, 'HSwish', 1)],
    }

    def __init__(self,
                 arch: str = 'large',
                 in_channels: int = 3,
                 out_indices: Sequence[int] = (1, 3, 16),
                 frozen_stages: int = -1,
                 norm_cfg: Optional[dict] = None,
                 norm_eval: bool = False,
                 pretrained: Optional[str] = None,
                 init_cfg: Optional[dict] = None):
        super().__init__()
        del frozen_stages, pretrained, init_cfg
        self.norm_eval = norm_eval
        self.out_indices = tuple(out_indices)
        self.layers = self.settings[arch]
        self.stem = ConvModule(in_channels, 16, 3, stride=2, padding=1,
                               norm_cfg=norm_cfg, act_cfg={'type': 'HSwish'})
        ch = 16
        chans = [ch] if 0 in self.out_indices else []
        for i, (k, exp, out_ch, se, act, stride) in enumerate(self.layers):
            act_cfg = {'type': act}
            if exp != ch:
                self.add_module(f'b{i}_expand', ConvModule(
                    ch, exp, 1, norm_cfg=norm_cfg, act_cfg=act_cfg))
            self.add_module(f'b{i}_dw', ConvModule(
                exp, exp, k, stride=stride, padding=k // 2, groups=exp,
                norm_cfg=norm_cfg, act_cfg=act_cfg))
            if se:
                self.add_module(f'b{i}_se1',
                                nn.Conv2d(exp, _se_width(exp), 1))
                self.add_module(f'b{i}_se2',
                                nn.Conv2d(_se_width(exp), exp, 1))
            self.add_module(f'b{i}_project', ConvModule(
                exp, out_ch, 1, norm_cfg=norm_cfg, act_cfg=_NO_ACT))
            ch = out_ch
            if (i + 1) in self.out_indices:
                chans.append(ch)
        last = 576 if arch == 'small' else 960
        self.final = ConvModule(ch, last, 1, norm_cfg=norm_cfg,
                                act_cfg={'type': 'HSwish'})
        self.final_out = len(self.layers) + 1 in self.out_indices or \
            16 in self.out_indices
        if self.final_out:
            chans.append(last)
        self.feature_channels = tuple(chans)

    def forward(self, x):
        x = self.stem(x)
        outs = [x] if 0 in self.out_indices else []
        for i, (_, _, _, se, _, stride) in enumerate(self.layers):
            h = x
            if hasattr(self, f'b{i}_expand'):
                h = getattr(self, f'b{i}_expand')(h)
            h = getattr(self, f'b{i}_dw')(h)
            if se:
                h = _se_gate(h, getattr(self, f'b{i}_se1'),
                             getattr(self, f'b{i}_se2'))
            h = getattr(self, f'b{i}_project')(h)
            x = h + x if stride == 1 and h.shape[1] == x.shape[1] else h
            if (i + 1) in self.out_indices:
                outs.append(x)
        x = self.final(x)
        if self.final_out:
            outs.append(x)
        return tuple(outs)
