"""Fully-convolutional domain discriminator (port of
``pfst_tpu/models/discriminators/fc_discriminator.py``; mirrors
``rsiseg/models/discriminators/fc_discriminator.py``), on NCHW tensors.

Five 4x4 convolutions ``conv0`` ... ``conv4`` (the rsiseg state-dict
names), widths ndf, 2 ndf, 4 ndf, 8 ndf and 1, leaky ReLU 0.2 between
them, then the mean over the map. Each convolution has stride 2 and
padding 1, unless the smaller side of its input is under 4: then, as the
JAX module decides from the static shape, stride 1 and XLA's ``SAME``
padding, which for a 4-tap kernel pads 1 before and 2 after. The weights
do not depend on the branch.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.quant import track_root
from ..builder import DISCRIMINATORS
from ..utils.layers import lecun_normal_


@DISCRIMINATORS.register_module()
class FCDiscriminator(nn.Module):

    def __new__(cls, *args, **kwargs):
        # a root the int8 and QAT contexts name (copies too)
        return track_root(super().__new__(cls))

    def __init__(self, num_in_channels: int = 19, ndf: int = 64):
        super().__init__()
        widths = [ndf, ndf * 2, ndf * 4, ndf * 8, 1]
        cin = num_in_channels
        for i, w in enumerate(widths):
            setattr(self, f'conv{i}', nn.Conv2d(cin, w, 4, stride=2,
                                                padding=1))
            cin = w
        self.num_convs = len(widths)

    def init_weights(self, generator: torch.Generator):
        """flax's default ``nn.Conv`` initializers, which the JAX module
        keeps (``lecun_normal`` kernels), drawn from ``generator``; biases
        zero."""
        with torch.no_grad():
            for i in range(self.num_convs):
                conv = getattr(self, f'conv{i}')
                lecun_normal_(conv.weight, generator)
                conv.bias.zero_()
        return self

    def forward(self, x):
        for i in range(self.num_convs):
            conv = getattr(self, f'conv{i}')
            if min(x.shape[2], x.shape[3]) < 4:
                x = F.conv2d(F.pad(x, (1, 2, 1, 2)), conv.weight, conv.bias)
            else:
                x = conv(x)
            if i < self.num_convs - 1:
                x = F.leaky_relu(x, 0.2)
        return x.mean(dim=(2, 3), keepdim=True)
