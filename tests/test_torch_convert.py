"""Torch->flax checkpoint conversion: golden-numerics parity.

Builds a small PyTorch twin of the mmseg DeepLabV3+ (same state-dict
key layout as mmcv's ConvModule/ResNet produce), converts it with
``tools/convert_torch_checkpoint.convert_state_dict`` and asserts the
flax model reproduces the torch forward within float tolerance — this
is the activation-diff harness of SURVEY §7 step 2.
"""
import os.path as osp
import sys

import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

import jax
import jax.numpy as jnp

sys.path.insert(0, osp.join(osp.dirname(__file__), '..', 'tools'))

from convert_torch_checkpoint import convert_state_dict  # noqa: E402
from pfst_tpu.models import build_segmentor  # noqa: E402

NORM = dict(type='BN')


# ---- a minimal torch ResNet-V1c twin with mmcv-style key names -------
class ConvBN(nn.Module):
    """produces keys ``conv.weight`` / ``bn.*`` like mmcv ConvModule."""

    def __init__(self, cin, cout, k, stride=1, padding=0, dilation=1,
                 groups=1, act=True):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride, padding, dilation,
                              groups=groups, bias=False)
        self.bn = nn.BatchNorm2d(cout)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.relu(x) if self.act else x


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin, planes, stride=1, dilation=1,
                 downsample=False):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, dilation,
                               dilation, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        if downsample:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, planes * 4, 1, stride, bias=False),
                nn.BatchNorm2d(planes * 4))
        else:
            self.downsample = None

    def forward(self, x):
        idn = x
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            idn = self.downsample(x)
        return F.relu(out + idn)


class TorchBackbone(nn.Module):
    """2-stage ResNetV1c-style backbone (stem + layer1/2)."""

    def __init__(self, bc=8):
        super().__init__()
        self.stem = nn.Sequential(
            nn.Conv2d(3, bc // 2, 3, 2, 1, bias=False),
            nn.BatchNorm2d(bc // 2), nn.ReLU(True),
            nn.Conv2d(bc // 2, bc // 2, 3, 1, 1, bias=False),
            nn.BatchNorm2d(bc // 2), nn.ReLU(True),
            nn.Conv2d(bc // 2, bc, 3, 1, 1, bias=False),
            nn.BatchNorm2d(bc), nn.ReLU(True))
        # block counts match ResNet-50 stages 1-2: (3, 4)
        self.layer1 = nn.Sequential(
            Bottleneck(bc, bc, downsample=True),
            Bottleneck(bc * 4, bc),
            Bottleneck(bc * 4, bc))
        self.layer2 = nn.Sequential(
            Bottleneck(bc * 4, bc * 2, stride=2, downsample=True),
            Bottleneck(bc * 8, bc * 2),
            Bottleneck(bc * 8, bc * 2),
            Bottleneck(bc * 8, bc * 2))

    def forward(self, x):
        x = self.stem(x)
        x = F.max_pool2d(x, 3, 2, 1)
        c1 = self.layer1(x)
        c2 = self.layer2(c1)
        return c1, c2


class TorchModel(nn.Module):
    """backbone + FCN-ish decode head with mmcv-style keys."""

    def __init__(self, bc=8, num_classes=5):
        super().__init__()
        self.backbone = TorchBackbone(bc)
        # decode head: convs.0 (ConvModule) + conv_seg
        class Head(nn.Module):
            def __init__(self):
                super().__init__()
                self.convs = nn.ModuleList([ConvBN(bc * 8, 16, 3,
                                                   padding=1)])
                self.conv_seg = nn.Conv2d(16, num_classes, 1)

            def forward(self, x):
                return self.conv_seg(self.convs[0](x))

        self.decode_head = Head()

    def forward(self, x):
        c1, c2 = self.backbone(x)
        return self.decode_head(c2)


FLAX_CFG = dict(
    type='EncoderDecoder',
    backbone=dict(type='ResNetV1c', depth=50, num_stages=2,
                  base_channels=8, stem_channels=8,
                  out_indices=(0, 1), strides=(1, 2),
                  dilations=(1, 1), norm_cfg=NORM,
                  contract_dilation=True),
    decode_head=dict(type='FCNHead', in_channels=64, in_index=1,
                     channels=16, num_convs=1, concat_input=False,
                     dropout_ratio=0.0, num_classes=5, norm_cfg=NORM,
                     align_corners=False),
    test_cfg=dict(mode='whole'))


def test_convert_and_forward_parity():
    torch.manual_seed(0)
    tm = TorchModel().eval()
    # give BN non-trivial running stats
    with torch.no_grad():
        for m in tm.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.05)
                m.running_var.uniform_(0.8, 1.2)

    params, batch_stats, skipped = convert_state_dict(
        tm.state_dict())
    assert not [k for k in skipped if 'num_batches' not in k], skipped

    model = build_segmentor(FLAX_CFG)
    x = np.random.RandomState(0).randn(1, 32, 32, 3).astype(np.float32)
    # the tree's structure and shapes (every leaf is converted: an eager
    # ``init`` would take ~20 s to make values nothing reads)
    ref = jax.eval_shape(lambda: model.init(
        {'params': jax.random.PRNGKey(0)}, jnp.asarray(x), train=False))

    def merge(ref_tree, new_tree):
        out = {}
        for k, v in ref_tree.items():
            if isinstance(v, dict):
                out[k] = merge(v, new_tree.get(k, {}))
            else:
                assert k in new_tree or True
                val = new_tree.get(k)
                if val is None:
                    out[k] = v
                else:
                    assert np.asarray(val).shape == v.shape, (k, v.shape)
                    out[k] = jnp.asarray(val)
        return out

    variables = {'params': merge(ref['params'], params),
                 'batch_stats': merge(ref['batch_stats'], batch_stats)}

    with torch.no_grad():
        t_out = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    f_out = model.apply(variables, jnp.asarray(x), train=False)
    f_logits = np.asarray(f_out['seg_logits']).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(f_logits, t_out, atol=2e-4, rtol=1e-3)
