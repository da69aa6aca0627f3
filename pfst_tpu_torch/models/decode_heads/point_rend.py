"""PointRend, STDC's detail head, DPT and K-Net on NCHW maps (port of
``pfst_tpu/models/decode_heads/point_rend.py``): ``calculate_uncertainty``
and ``PointRendHead`` (``:36-165``, registered again as ``PointHead``),
``STDCHead`` (``:168-199``), ``DPTHead`` (``:202-256``) and the K-Net
stack (``:262-552``).

``PointRendHead``: its own coarse branch (``coarse_conv``,
``coarse_cls``) when it stands alone; as a later stage of
``CascadeEncoderDecoder`` (``prev_stage``) the previous stage's logits are
the coarse ones and the branch does not exist, as in the JAX tree. In
eval mode the top ``min(num_points, h w)`` uncertainties of the coarse
logits are refined once, at the coarse resolution, by the point MLP
(Dense ``fc{i}`` and ``point_cls`` over the fine features and the coarse
logits at each point, the logits fed again to every layer with
``coarse_pred_each_layer``); mmseg subdivides, the JAX file does not, and
reads no ``subdivision_*`` from ``test_cfg``. ``point_losses`` samples the
training points: ``num_points * oversample_ratio`` uniform coordinates,
the ``importance_sample_ratio`` share of them with the most uncertain
sampled logits, uniform ones for the rest; labels sampled nearest. The
two uniform tensors are drawn on the CPU's default generator (the train
step seeds it), or passed in as ``draws``. ``num_points``,
``oversample_ratio`` and ``importance_sample_ratio`` are the head's own
fields, as in the JAX file.

``STDCHead``: an ``FCNHead`` whose targets are the labels' Laplacian
boundaries at strides 1, 2 and 4 (zero padding; ignored 255s enter it as
values), the coarser two brought up nearest, fused 0.6 / 0.3 / 0.1 and
thresholded (``transform_targets``).

``DPTHead``: the JAX file's reassembly: per ViT tap a 1x1 conv to
``post_process_channels[i]`` (``reassemble.{i}``), a bilinear resize by
(4, 2, 1, 0.5) (the 0.5 a downscale without antialiasing, as
``pfst_tpu/ops/resize.py`` does it) and a 3x3 conv to ``channels``
(``project.{i}``), both with bias, no norm and no activation; then a
top-down fusion, each level's sum through a 3x3 ConvModule
(``fuse.{i}``), a last one (``head_conv``) and the classifier. mmseg's
DPT reads out the class token and reassembles by deconvolution; this
head keeps the JAX file's structure under its names (``reassemble{i}``,
``project{i}``, ``fuse{i}``, ``head_conv``). ``readout_type`` and
``embed_dims`` are accepted and unused, as in the JAX file.

K-Net: ``IterativeDecodeHead`` runs its kernel-generate head (``kgh``),
whose classifier weight itself, tiled over the batch, is the stage-0
kernels (the stage losses reach ``conv_seg`` through them), then
``num_stages`` ``KernelUpdateHead``s (``update_head{i}``). A stage
assembles each kernel's features by a softmax of the masks over the N
kernels (the JAX file's ``sigmoid_masks`` is a softmax), updates the
kernels (``KernelUpdator``, ``kernel_update_conv``), attends between
them (``KernelMHA``, ``attention.{qkv,proj}``, through ``ops.attention``:
the flash kernels on the card; the residual adds the identity), and runs
the FFN and mask FCs; its masks are the 1x1 dynamic conv, or with
``conv_kernel_size`` k > 1 the per-image k x k one (a grouped conv over
the batch, padding k // 2), the 1x1 seed zero-embedded at the window's
centre. LayerNorms at flax's eps 1e-6. The group assembling and the
dynamic conv are fp32 products with autocast off; the attention takes
the Dense layers' type (bf16 under autocast), P rounded to it before
``P V``, as the flash kernels and the JAX file round it.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops import attention, point_sample, resize
from ..builder import HEADS, build_head
from ..utils.layers import ConvModule
from .attention_heads import ClsSeg
from .base import BaseDecodeHead
from .fcn_head import FCNHead

_NO_ACT = {'type': 'none'}
_SCALES = (4, 2, 1, 0.5)


@HEADS.register_module()
class DPTHead(BaseDecodeHead):

    def __init__(self, in_channels: Sequence[int] = (768,) * 4,
                 channels: int = 256, num_classes: int = 19,
                 embed_dims: int = 768,
                 post_process_channels: Sequence[int] = (96, 192, 384, 768),
                 readout_type: str = 'ignore', in_index=(0, 1, 2, 3),
                 input_transform='multiple_select', **kwargs):
        super().__init__(list(in_channels), channels, num_classes,
                         in_index=list(in_index),
                         input_transform=input_transform, **kwargs)
        del embed_dims, readout_type
        self.reassemble = nn.ModuleList(
            ConvModule(c, p, 1, act_cfg=_NO_ACT)
            for c, p in zip(in_channels, post_process_channels))
        self.project = nn.ModuleList(
            ConvModule(p, channels, 3, padding=1, act_cfg=_NO_ACT)
            for p in post_process_channels)
        self.fuse = nn.ModuleList(
            ConvModule(channels, channels, 3, padding=1,
                       norm_cfg=self.norm_cfg)
            for _ in range(len(in_channels) - 1))
        self.head_conv = ConvModule(channels, channels, 3, padding=1,
                                    norm_cfg=self.norm_cfg)

    def forward(self, inputs):
        pyramid = []
        for i, s in zip(self.in_index, _SCALES):
            y = self.reassemble[len(pyramid)](inputs[i])
            if s != 1:
                y = resize(y, scale_factor=s, mode='bilinear',
                           align_corners=self.align_corners)
            pyramid.append(self.project[len(pyramid)](y))
        out = pyramid[-1]
        for i in range(len(pyramid) - 2, -1, -1):
            out = resize(out, size=pyramid[i].shape[2:], mode='bilinear',
                         align_corners=self.align_corners)
            out = self.fuse[i](pyramid[i] + out)
        feats = self.head_conv(out)
        return self.cls_seg(feats), feats


def calculate_uncertainty(logits, dim: int = 1):
    """The negated margin of the two highest logits along ``dim``,
    ``-(top1 - top2)`` (``point_rend.py:36-41``)."""
    top2 = logits.topk(2, dim=dim).values
    return -(top2.select(dim, 0) - top2.select(dim, 1))


def _gather_points(feat, idx):
    """(B, C, H, W) at the flat positions ``idx`` (B, n) -> (B, n, C)."""
    idx = idx[:, None].expand(-1, feat.shape[1], -1)
    return feat.flatten(2).gather(2, idx).transpose(1, 2)


@HEADS.register_module()
class PointRendHead(nn.Module):

    def __init__(self, in_channels: Sequence[int] = (256,),
                 channels: int = 256, num_classes: int = 19, num_fcs: int = 3,
                 num_points: int = 2048, oversample_ratio: int = 3,
                 importance_sample_ratio: float = 0.75,
                 coarse_pred_each_layer: bool = True,
                 dropout_ratio: float = 0.1, in_index=(0,),
                 input_transform: Optional[str] = 'multiple_select',
                 align_corners: bool = False, norm_cfg: Optional[dict] = None,
                 act_cfg: Optional[dict] = None, ignore_index: int = 255,
                 loss_decode=None, sampler: Optional[dict] = None,
                 prev_stage: bool = False):
        super().__init__()
        del act_cfg, loss_decode
        self.in_index = [in_index] if isinstance(in_index, int) \
            else list(in_index)
        self.input_transform = input_transform
        self.num_classes = num_classes
        self.num_fcs = num_fcs
        self.num_points = num_points
        self.oversample_ratio = oversample_ratio
        self.importance_sample_ratio = importance_sample_ratio
        self.coarse_pred_each_layer = coarse_pred_each_layer
        self.align_corners = align_corners
        self.ignore_index = ignore_index
        self.sampler = sampler
        fine = in_channels if isinstance(in_channels, int) else in_channels[0]
        if not prev_stage:
            self.coarse_conv = ConvModule(fine, channels, 3, padding=1,
                                          norm_cfg=norm_cfg)
            self.coarse_cls = ClsSeg(channels, num_classes, dropout_ratio)
        width = fine + num_classes
        for i in range(num_fcs):
            self.add_module(f'fc{i}', nn.Linear(width, channels))
            width = channels + num_classes * coarse_pred_each_layer
        self.point_cls = nn.Linear(width, num_classes)

    def _point_mlp(self, fine_pts, coarse_pts):
        """The point MLP over (B, n, C) fine features and (B, n, K) coarse
        logits -> (B, n, K) (``point_rend.py:83-90``)."""
        y = torch.cat([fine_pts, coarse_pts], dim=-1)
        for i in range(self.num_fcs):
            y = F.relu(getattr(self, f'fc{i}')(y))
            if self.coarse_pred_each_layer:
                y = torch.cat([y, coarse_pts], dim=-1)
        return self.point_cls(y)

    def forward(self, inputs, prev_logits=None):
        fine = inputs[self.in_index[0]]
        if prev_logits is not None:
            feats, coarse = fine, prev_logits
        else:
            feats = self.coarse_conv(fine)
            coarse = self.coarse_cls(feats)
        if self.training:
            return coarse, feats
        b, k, h, w = coarse.shape
        n = min(self.num_points, h * w)
        idx = calculate_uncertainty(coarse).flatten(1).topk(n, dim=1).indices
        pts = self._point_mlp(_gather_points(fine, idx),
                              _gather_points(coarse, idx))
        refined = coarse.flatten(2).scatter(
            2, idx[:, None].expand(-1, k, -1),
            pts.transpose(1, 2).to(coarse.dtype))
        return refined.view(b, k, h, w), feats

    def point_losses(self, inputs, gt, coarse_logits=None, draws=None):
        """``(point_logits (B, N, K), point_label (B, N))`` at the training
        points (``point_rend.py:124-165``). ``draws``: the two uniform
        (B, num_points * oversample_ratio, 2) and (B, N - importance
        share, 2) tensors, else drawn on the CPU's default generator."""
        fine = inputs[self.in_index[0]]
        if coarse_logits is None:
            coarse_logits = self.coarse_cls(self.coarse_conv(fine))
        b = coarse_logits.shape[0]
        n_unc = int(self.importance_sample_ratio * self.num_points)
        if draws is None:
            draws = (torch.rand((b, int(self.num_points *
                                        self.oversample_ratio), 2)),
                     torch.rand((b, self.num_points - n_unc, 2)))
        coords, rand = (d.to(coarse_logits.device) for d in draws)
        ac = self.align_corners
        unc = calculate_uncertainty(
            point_sample(coarse_logits, coords, align_corners=ac), dim=-1)
        idx = unc.topk(n_unc, dim=1).indices
        coords = torch.cat([coords.gather(1, idx[..., None].expand(-1, -1, 2)),
                            rand], dim=1)
        logits = self._point_mlp(
            point_sample(fine, coords, align_corners=ac),
            point_sample(coarse_logits, coords, align_corners=ac))
        label = point_sample(gt.float()[:, None], coords, mode='nearest',
                             align_corners=ac)[..., 0]
        return logits, label.long()


# the cascade defs name the PointRend stage 'PointHead'
HEADS.register_module(name='PointHead', module=PointRendHead)


@HEADS.register_module()
class STDCHead(FCNHead):

    def __init__(self, *args, boundary_threshold: float = 0.1, **kwargs):
        super().__init__(*args, **kwargs)
        self.boundary_threshold = boundary_threshold

    def transform_targets(self, seg_label):
        """(B, H, W) labels -> (B, H, W) binary boundary targets
        (``point_rend.py:176-199``)."""
        lap = torch.tensor([[-1.0, -1.0, -1.0], [-1.0, 8.0, -1.0],
                            [-1.0, -1.0, -1.0]],
                           device=seg_label.device).view(1, 1, 3, 3)
        x = seg_label.float()[:, None]
        thr = self.boundary_threshold
        with torch.autocast(x.device.type, enabled=False):
            t1, t2, t4 = (F.conv2d(x, lap, stride=s, padding=1).clamp(min=0)
                          for s in (1, 2, 4))
        t1 = (t1 > thr).float()
        t2, t4 = ((resize(t, size=t1.shape[2:], mode='nearest') > thr).float()
                  for t in (t2, t4))
        fused = 0.6 * t1 + 0.3 * t2 + 0.1 * t4
        return (fused[:, 0] > thr).long()


def _layer_norm(dim):
    return nn.LayerNorm(dim, eps=1e-6)


class KernelUpdator(nn.Module):
    """The feature-gated kernel update (``point_rend.py:262-315``)."""

    def __init__(self, in_channels: int = 256, feat_channels: int = 64,
                 out_channels: Optional[int] = None,
                 gate_sigmoid: bool = True, gate_norm_act: bool = False,
                 activate_out: bool = False):
        super().__init__()
        out_channels = out_channels or in_channels
        fc = feat_channels
        self.feat_channels = fc
        self.gate_sigmoid = gate_sigmoid
        self.gate_norm_act = gate_norm_act
        self.activate_out = activate_out
        self.dynamic_layer = nn.Linear(in_channels, 2 * fc)
        self.input_layer = nn.Linear(in_channels, 2 * fc)
        if gate_norm_act:
            self.gate_norm = _layer_norm(fc)
        self.input_gate = nn.Linear(fc, fc)
        self.update_gate = nn.Linear(fc, fc)
        for name in ('input_norm_in', 'norm_in', 'norm_out',
                     'input_norm_out'):
            self.add_module(name, _layer_norm(fc))
        self.fc_layer = nn.Linear(fc, out_channels)
        self.fc_norm = _layer_norm(out_channels)

    def forward(self, update_feature, input_feature):
        """(B, N, C) assembled features, (B, N, KK, C) kernels -> (B, N,
        KK, out)."""
        fc = self.feat_channels
        params = self.dynamic_layer(update_feature)
        param_in, param_out = params[..., :fc], params[..., fc:]
        feats = self.input_layer(input_feature)
        input_in, input_out = feats[..., :fc], feats[..., fc:]
        gate = input_in * param_in[..., None, :]
        if self.gate_norm_act:
            gate = F.relu(self.gate_norm(gate))
        input_gate = self.input_norm_in(self.input_gate(gate))
        update_gate = self.norm_in(self.update_gate(gate))
        if self.gate_sigmoid:
            input_gate, update_gate = (torch.sigmoid(input_gate),
                                       torch.sigmoid(update_gate))
        param_out = self.norm_out(param_out)
        input_out = self.input_norm_out(input_out)
        if self.activate_out:
            param_out, input_out = F.relu(param_out), F.relu(input_out)
        features = update_gate * param_out[..., None, :] + \
            input_gate * input_out
        return F.relu(self.fc_norm(self.fc_layer(features)))


class KernelMHA(nn.Module):
    """Attention between the kernels with the identity added
    (``point_rend.py:318-342``), through ``ops.attention``."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, n, c = x.shape
        hd = c // self.num_heads
        q, k, v = self.qkv(x).view(b, n, 3, self.num_heads, hd).permute(
            2, 0, 3, 1, 4)
        o = attention(q, k, v, hd**-0.5)
        return x + self.proj(o.transpose(1, 2).reshape(b, n, c))


class KernelUpdateHead(nn.Module):
    """One K-Net stage (``point_rend.py:345-466``)."""

    def __init__(self, num_classes: int = 150, num_ffn_fcs: int = 2,
                 num_heads: int = 8, num_mask_fcs: int = 3,
                 feedforward_channels: int = 2048, in_channels: int = 256,
                 out_channels: int = 256, conv_kernel_size: int = 1,
                 with_ffn: bool = True,
                 feat_transform_cfg: Optional[dict] = None,
                 kernel_updator_cfg: Optional[dict] = None):
        super().__init__()
        del num_classes
        k = conv_kernel_size
        assert k % 2 == 1, f'conv_kernel_size must be odd, got {k}'
        self.k = k
        self.num_ffn_fcs = num_ffn_fcs if with_ffn else 0
        self.num_mask_fcs = num_mask_fcs
        self.out_channels = out_channels
        if feat_transform_cfg is not None:
            self.feat_transform = ConvModule(
                in_channels, in_channels, 1,
                norm_cfg=feat_transform_cfg.get('norm_cfg'),
                act_cfg=feat_transform_cfg.get('act_cfg'))
        upd = dict(kernel_updator_cfg or {})
        upd.pop('type', None)
        upd.setdefault('in_channels', in_channels)
        self.kernel_update_conv = KernelUpdator(**upd)
        self.attention = KernelMHA(in_channels * k * k, num_heads)
        self.attention_norm = _layer_norm(in_channels * k * k)
        if with_ffn:
            width = in_channels
            for i in range(num_ffn_fcs - 1):
                self.add_module(f'ffn_fc{i}',
                                nn.Linear(width, feedforward_channels))
                width = feedforward_channels
            self.add_module(f'ffn_fc{num_ffn_fcs - 1}',
                            nn.Linear(width, in_channels))
            self.ffn_norm = _layer_norm(in_channels)
        for i in range(num_mask_fcs):
            self.add_module(f'mask_fc{i}',
                            nn.Linear(in_channels, in_channels, bias=False))
            self.add_module(f'mask_norm{i}', _layer_norm(in_channels))
        self.fc_mask = nn.Linear(in_channels, out_channels)

    def forward(self, x, kernels, mask_preds):
        """x (B, C, H, W), kernels (B, N, C) or (B, N, KK, C), mask_preds
        (B, N, H', W') -> (new masks (B, N, H, W), new kernels: (B, N, C)
        where k is 1, else (B, N, KK, C))."""
        k, kk = self.k, self.k * self.k
        if kernels.ndim == 3:
            kernels = kernels[:, :, None]
        if kernels.shape[2] != kk:
            # the 1x1 seed at the centre of a k x k window
            assert kernels.shape[2] == 1, (kernels.shape, k)
            zeros = kernels.new_zeros(*kernels.shape[:2], (kk - 1) // 2,
                                      kernels.shape[-1])
            kernels = torch.cat([zeros, kernels, zeros], dim=2)
        if hasattr(self, 'feat_transform'):
            x = self.feat_transform(x)
        if mask_preds.shape[2:] != x.shape[2:]:
            mask_preds = resize(mask_preds, size=x.shape[2:], mode='bilinear',
                                align_corners=False)
        with torch.autocast(x.device.type, enabled=False):
            # group feature assembling: a softmax over the kernels
            masks = torch.softmax(mask_preds.float(), dim=1)
            x_feat = torch.einsum('bnhw,bchw->bnc',
                                  masks.to(x.dtype).float(), x.float())
        obj = self.kernel_update_conv(x_feat.to(x.dtype), kernels)
        b, n = obj.shape[:2]
        obj = self.attention_norm(self.attention(obj.reshape(b, n, -1)))
        obj = obj.reshape(b, n, kk, -1)
        if self.num_ffn_fcs:
            y = obj
            for i in range(self.num_ffn_fcs - 1):
                y = F.relu(getattr(self, f'ffn_fc{i}')(y))
            y = getattr(self, f'ffn_fc{self.num_ffn_fcs - 1}')(y)
            obj = self.ffn_norm(obj + y)
        mask_feat = obj
        for i in range(self.num_mask_fcs):
            mask_feat = F.relu(getattr(self, f'mask_norm{i}')(
                getattr(self, f'mask_fc{i}')(mask_feat)))
        mask_feat = self.fc_mask(mask_feat)                  # (B, N, KK, C)
        h, w = x.shape[2:]
        with torch.autocast(x.device.type, enabled=False):
            if k == 1:
                new_mask = torch.einsum('bchw,bnc->bnhw', x.float(),
                                        mask_feat[:, :, 0].float())
            else:
                # per image a k x k conv to N masks: one grouped conv
                weight = mask_feat.reshape(b, n, k, k, -1).permute(
                    0, 1, 4, 2, 3).reshape(b * n, -1, k, k)
                new_mask = F.conv2d(x.float().reshape(1, -1, h, w),
                                    weight.float(), padding=k // 2,
                                    groups=b).view(b, n, h, w)
        return new_mask.to(x.dtype), obj[:, :, 0] if k == 1 else obj


@HEADS.register_module()
class IterativeDecodeHead(nn.Module):
    """K-Net (``point_rend.py:469-552``): the kernel-generate head
    (``kgh``) and the kernel-update stages (``update_head{i}``); training
    takes a loss of every stage (``all_stage_logits``)."""

    def __init__(self, num_stages: int = 3,
                 kernel_generate_head: Optional[dict] = None,
                 kernel_update_head: Optional[Sequence[dict]] = None,
                 in_channels=None, channels=None, dropout_ratio: float = 0.1,
                 in_index=3, input_transform: Optional[str] = None,
                 align_corners: bool = False,
                 norm_cfg: Optional[dict] = None,
                 act_cfg: Optional[dict] = None, ignore_index: int = 255,
                 loss_decode=None, sampler: Optional[dict] = None,
                 num_classes: int = 19):
        super().__init__()
        del dropout_ratio, input_transform, act_cfg, loss_decode
        gen = dict(kernel_generate_head or dict(
            type='FCNHead', in_channels=in_channels or 512,
            channels=channels or 256, num_convs=1, concat_input=False,
            num_classes=num_classes, in_index=in_index, norm_cfg=norm_cfg,
            dropout_ratio=0.0))
        self.kgh = build_head(gen)
        upd = list(kernel_update_head or []) or [dict(
            in_channels=gen.get('channels', 256),
            out_channels=gen.get('channels', 256), num_classes=num_classes,
            feedforward_channels=512)] * num_stages
        for i, c in enumerate(upd):
            c = dict(c)
            c.pop('type', None)
            self.add_module(f'update_head{i}', KernelUpdateHead(**c))
        self.num_update = len(upd)
        self.align_corners = align_corners
        self.ignore_index = ignore_index
        self.sampler = sampler
        self.num_classes = num_classes

    def all_stage_logits(self, inputs):
        """Every stage's logits, the generate head's first, and the
        generate head's features."""
        logits, feats = self.kgh(inputs)[:2]
        # the classifier's weight itself, so the stages' losses reach it
        kernels = self.kgh.conv_seg.weight[:, :, 0, 0][None].expand(
            feats.shape[0], -1, -1)                          # (B, N, C)
        stage_logits = [logits]
        for i in range(self.num_update):
            logits, kernels = getattr(self, f'update_head{i}')(
                feats, kernels, logits)
            stage_logits.append(logits)
        return stage_logits, feats

    def forward(self, inputs):
        stage_logits, feats = self.all_stage_logits(inputs)
        return stage_logits[-1], feats
