"""EncoderDecoder segmentor on NCHW tensors (port of
``pfst_tpu/models/segmentors/encoder_decoder.py``).

Attributes ``backbone``, ``decode_head`` and ``auxiliary_head`` give the
rsiseg state-dict prefixes. Inference follows
``encoder_decoder.py:72-84,220-327``: ``encode_decode`` resizes the head
logits to the input, ``slide_inference`` averages overlapping windows
over the same grid as the JAX ``fori_loop`` (here a plain loop), and
``inference`` softmaxes after the rescale. ``forward_train``
(``encoder_decoder.py:140-241``): decode and auxiliary losses under the
``decode.`` / ``aux.`` prefixes, in fp32, with the EncNet branch (the SE
loss ``decode.loss_se`` from the same forward) and the DAHead branch (a
loss of each of its outputs, ``decode.pam_cam.*``, ``decode.pam.*``,
``decode.cam.*``), K-Net's loss of every stage (``decode.{name}.s{i}``,
``encoder_decoder.py:140-166``) and PointRend's point loss beside the
dense one (``decode.pointloss_ce``, ``decode.acc_point``, ``:214-227``);
a head's ``transform_targets`` (STDC's boundaries) turns the labels
before its loss, and its ``sampler`` (OHEM) gives the pixel weights in
place of ``seg_weight`` (``:26-52``). Inference reads a head's first two
outputs. Where a backbone or neck declares the widths
of its outputs (``feature_channels``), the next module is built at the
width it is fed, as flax infers it, and not at the one its config
declares (``_at_fed_width``).
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Union

import torch
import torch.nn as nn

from ...core.seg import build_pixel_sampler
from ...ops import resize
from ...ops.quant import track_root
from ...utils.misc import add_prefix
from ..builder import (SEGMENTORS, build_backbone, build_head, build_loss,
                       build_neck)
from ..losses.accuracy import accuracy
from ..utils.layers import init_conv_, lecun_normal_


def _head_losses(head, loss_fns, seg_logit, seg_label, seg_weight=None):
    """The head's targets (``transform_targets``), its logits resized to
    the label size in fp32, its sampler's pixel weights in place of
    ``seg_weight``, each loss, then the pixel accuracy
    (``encoder_decoder.py:26-51``)."""
    if hasattr(head, 'transform_targets'):
        seg_label = head.transform_targets(seg_label)
    seg_logit = resize(seg_logit.float(), size=seg_label.shape[1:],
                       mode='bilinear', align_corners=head.align_corners)
    if getattr(head, 'sampler', None) is not None:
        sampler = build_pixel_sampler(head.sampler,
                                      ignore_index=head.ignore_index)
        seg_weight = sampler.sample(seg_logit, seg_label)
    loss = {}
    for loss_fn in loss_fns:
        name = loss_fn.loss_name
        val = loss_fn(seg_logit, seg_label, weight=seg_weight,
                      ignore_index=head.ignore_index)
        loss[name] = loss[name] + val if name in loss else val
    loss['acc_seg'] = accuracy(seg_logit, seg_label,
                               ignore_index=head.ignore_index)
    return loss


def _point_losses(head, loss_fns, point_logits, point_label):
    """The losses of (B, N, K) point logits against (B, N) labels, each
    under ``point`` and its name, and ``acc_point`` (the JAX file's (B, N,
    1, K) spatial form, here (B, K, N, 1))."""
    logits, label = point_logits.float().permute(0, 2, 1)[..., None], \
        point_label[..., None]
    loss = {}
    for loss_fn in loss_fns:
        name = 'point' + loss_fn.loss_name
        val = loss_fn(logits, label, ignore_index=head.ignore_index)
        loss[name] = loss[name] + val if name in loss else val
    loss['acc_point'] = accuracy(logits, label,
                                 ignore_index=head.ignore_index)
    return loss


def _build_losses(loss_cfg):
    if loss_cfg is None:
        loss_cfg = {'type': 'CrossEntropyLoss', 'use_sigmoid': False,
                    'loss_weight': 1.0}
    if isinstance(loss_cfg, (list, tuple)):
        return tuple(build_loss(c) for c in loss_cfg)
    return (build_loss(loss_cfg),)


def _at_fed_width(cfg, channels):
    """``cfg`` with ``in_channels`` the width it is fed, by its
    ``in_index`` and ``input_transform`` (one width, their sum for
    ``resize_concat``, or a list), where the module before declares its
    outputs' widths ``channels`` (``feature_channels``): flax infers a
    conv's input width from what it is fed, so the JAX program builds each
    head at that width, whatever the config declares (ICNet's decode head
    is declared 128 wide and fed ICNet's 256-channel map, CGNet's 256 and
    fed 128)."""
    if channels is None:
        return cfg
    idx, transform = cfg['in_index'], cfg.get('input_transform')
    if isinstance(idx, int) and transform is None:
        return {**cfg, 'in_channels': channels[idx]}
    widths = [channels[i] for i in ([idx] if isinstance(idx, int) else idx)]
    return {**cfg, 'in_channels': sum(widths)
            if transform == 'resize_concat' else widths}


@SEGMENTORS.register_module()
class EncoderDecoder(nn.Module):

    def __new__(cls, *args, **kwargs):
        # a root the int8 and QAT contexts name (copies too)
        return track_root(super().__new__(cls))

    def __init__(self,
                 backbone: dict,
                 decode_head: dict,
                 neck: Optional[dict] = None,
                 auxiliary_head: Optional[Union[dict, Sequence[dict]]] = None,
                 train_cfg: Optional[dict] = None,
                 test_cfg: Optional[dict] = None,
                 pretrained: Optional[str] = None,
                 init_cfg: Optional[dict] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        del init_cfg
        backbone = dict(backbone)
        if pretrained is not None:
            backbone.setdefault('pretrained', pretrained)
        self.backbone = build_backbone(backbone)
        widths = getattr(self.backbone, 'feature_channels', None)
        self.neck = None
        if neck:
            self.neck = build_neck(neck if widths is None else
                                   {**neck, 'in_channels': list(widths)})
            widths = getattr(self.neck, 'feature_channels', None)
        self.decode_head = self._build_decode_head(decode_head, widths)
        if isinstance(auxiliary_head, (list, tuple)):
            self.auxiliary_head = nn.ModuleList(
                build_head(_at_fed_width(a, widths)) for a in auxiliary_head)
        elif auxiliary_head is not None:
            self.auxiliary_head = build_head(_at_fed_width(auxiliary_head,
                                                           widths))
        else:
            self.auxiliary_head = None
        self.train_cfg = train_cfg
        self.test_cfg = test_cfg
        self._decode_losses = self._build_decode_losses(decode_head)
        aux_cfgs = [] if auxiliary_head is None else (
            list(auxiliary_head) if isinstance(auxiliary_head, (list, tuple))
            else [auxiliary_head])
        self._aux_losses = tuple(_build_losses(a.get('loss_decode'))
                                 for a in aux_cfgs)
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f'dtype must be float32 or bfloat16, got {dtype}')
        self.dtype = dtype

    def _build_decode_head(self, cfg, widths):
        return build_head(_at_fed_width(cfg, widths))

    def _build_decode_losses(self, cfg):
        return _build_losses(cfg.get('loss_decode'))

    @property
    def align_corners(self):
        return self.decode_head.align_corners

    @property
    def num_classes(self):
        return self.decode_head.num_classes

    def init_weights(self, generator: torch.Generator):
        """The JAX package's initializers, drawn from ``generator``:
        convs truncated-normal fan-out (``layers.py:126-127``), the
        classifiers normal(0.01) (``base.py:55``), Dense layers flax's
        default lecun-normal, biases zero, norms
        at scale 1, shift 0, running mean 0 and variance 1, learned
        scalars (``gamma``) 0; a module with its own draws (``draw_``:
        EncNet's codewords, EMANet's bases) makes them. A child with
        its own ``init_weights`` (the ViT backbone: flax's default Dense
        and Conv initializers) initializes itself."""
        own = [m for m in self.children() if hasattr(m, 'init_weights')]
        skip = {id(x) for m in own for x in m.modules()}
        with torch.no_grad():
            for name, m in self.named_modules():
                if id(m) in skip:
                    continue
                if isinstance(m, nn.Conv2d):
                    if name.endswith('conv_seg'):
                        m.weight.normal_(0.0, 0.01, generator=generator)
                    else:
                        init_conv_(m.weight, generator)
                    if m.bias is not None:
                        m.bias.zero_()
                elif isinstance(m, nn.Linear):
                    lecun_normal_(m.weight, generator)
                    if m.bias is not None:
                        m.bias.zero_()
                if hasattr(m, 'draw_'):
                    m.draw_(generator)
        for m in own:
            m.init_weights(generator)
        return self

    def _autocast(self, img):
        """bf16 compute with fp32 parameters when built with
        ``dtype='bfloat16'``."""
        if self.dtype == torch.bfloat16:
            return torch.autocast(img.device.type, dtype=torch.bfloat16)
        return contextlib.nullcontext()

    # -- forward pieces ---------------------------------------------------
    def extract_feat(self, img):
        x = self.backbone(img)
        if self.neck is not None:
            x = self.neck(x)
        return x

    def forward(self, img, **head_kwargs):
        """Full forward returning everything downstream consumers need.
        ``head_kwargs`` go to the decode head (EncNet's ``with_se``); its
        outputs past the first two are ``branch_logits`` (DAHead's
        branches, EncNet's SE logits)."""
        with self._autocast(img):
            feats = self.extract_feat(img)
            logits, decoded, *branches = self.decode_head(feats,
                                                          **head_kwargs)
            aux_logits = tuple(h(feats)[0] for h in self._aux_heads())
        return {'feats': feats, 'seg_logits': logits,
                'decoded_features': decoded, 'aux_logits': aux_logits,
                'branch_logits': tuple(branches)}

    def encode_decode(self, img):
        """Logits resized to the input size (+ states)."""
        with self._autocast(img):
            feats = self.extract_feat(img)
            logits, decoded = self.decode_head(feats)[:2]
            out = resize(logits, size=img.shape[2:], mode='bilinear',
                         align_corners=self.align_corners)
        states = {'feats': feats, 'decoded_features': decoded,
                  'seg_logits': out, 'head_logits': logits}
        return out, states

    def _aux_heads(self):
        aux = self.auxiliary_head
        return [] if aux is None else (
            list(aux) if isinstance(aux, nn.ModuleList) else [aux])

    def forward_train(self, img, gt_semantic_seg, seg_weight=None):
        """Losses and states of one supervised pass
        (``encoder_decoder.py:140-241``). Dropout runs when the module is
        in train mode. Returns ``(losses, states)``, ``states =
        {seg_logits (head resolution), decoded_features, features}``."""
        gt = gt_semantic_seg.long()
        dh = self.decode_head
        if hasattr(dh, 'all_stage_logits'):
            # K-Net: a loss of every stage, from one forward
            with self._autocast(img):
                feats = self.extract_feat(img)
                stage_logits, decoded = dh.all_stage_logits(feats)
                aux_logits = tuple(h(feats)[0] for h in self._aux_heads())
            out = {'feats': feats, 'seg_logits': stage_logits[-1],
                   'decoded_features': decoded, 'aux_logits': aux_logits}
            losses = {}
            for i, logit in enumerate(stage_logits):
                stage = _head_losses(dh, self._decode_losses, logit, gt,
                                     seg_weight)
                losses.update(add_prefix({f'{k}.s{i}': v
                                          for k, v in stage.items()},
                                         'decode'))
        else:
            se = getattr(dh, 'use_se_loss', False)
            out = self(img, with_se=True) if se else self(img)
            branches = getattr(dh, 'branch_loss_names', ())
            primary = f'decode.{dh.primary_loss_name}' if branches \
                else 'decode'
            losses = add_prefix(_head_losses(
                dh, self._decode_losses, out['seg_logits'], gt, seg_weight),
                primary)
            for name, logit in zip(branches, out['branch_logits']):
                losses.update(add_prefix(
                    _head_losses(dh, self._decode_losses, logit, gt,
                                 seg_weight), f'decode.{name}'))
            if se:
                # EncNet's SE loss (``encoder_decoder.py:166-189``): the
                # SE logits' sigmoid CE against the classes present
                se_loss = build_loss(dict(dh.loss_se_decode or dict(
                    type='CrossEntropyLoss', use_sigmoid=True,
                    loss_weight=0.2)))
                losses['decode.loss_se'] = se_loss(
                    out['branch_logits'][0].float(),
                    dh.se_onehot_labels(gt))
        if hasattr(dh, 'point_losses'):
            # PointRend's point loss on the dense pass's coarse logits
            with self._autocast(img):
                points = dh.point_losses(out['feats'], gt,
                                         coarse_logits=out['seg_logits'])
            losses.update(add_prefix(
                _point_losses(dh, self._decode_losses, *points), 'decode'))
        losses.update(self._aux_head_losses(out['aux_logits'], gt,
                                            seg_weight))
        states = {'seg_logits': out['seg_logits'],
                  'decoded_features': out['decoded_features'],
                  'features': out['feats']}
        return losses, states

    def _aux_head_losses(self, aux_logits, gt, seg_weight):
        """The auxiliary heads' losses under ``aux`` (one head) or
        ``aux_{i}``."""
        heads = self._aux_heads()
        losses = {}
        for i, (head, logit) in enumerate(zip(heads, aux_logits)):
            prefix = 'aux' if len(heads) == 1 else f'aux_{i}'
            losses.update(add_prefix(
                _head_losses(head, self._aux_losses[i], logit, gt,
                             seg_weight), prefix))
        return losses

    # -- inference --------------------------------------------------------
    def whole_inference(self, img):
        return self.encode_decode(img)

    def slide_inference(self, img):
        """Overlap-averaged sliding-window logits
        (``encoder_decoder.py:220-263``)."""
        h_crop, w_crop = self.test_cfg['crop_size']
        h_stride, w_stride = self.test_cfg['stride']
        b, _, h_img, w_img = img.shape
        h_crop, w_crop = min(h_crop, h_img), min(w_crop, w_img)
        h_grids = max(h_img - h_crop + h_stride - 1, 0) // h_stride + 1
        w_grids = max(w_img - w_crop + w_stride - 1, 0) // w_stride + 1
        preds = img.new_zeros((b, self.num_classes, h_img, w_img),
                              dtype=torch.float32)
        count = img.new_zeros((b, 1, h_img, w_img), dtype=torch.float32)
        for hi in range(h_grids):
            for wi in range(w_grids):
                y1 = max(min(hi * h_stride + h_crop, h_img) - h_crop, 0)
                x1 = max(min(wi * w_stride + w_crop, w_img) - w_crop, 0)
                crop = img[:, :, y1:y1 + h_crop, x1:x1 + w_crop]
                logit, _ = self.encode_decode(crop)
                preds[:, :, y1:y1 + h_crop, x1:x1 + w_crop] += logit
                count[:, :, y1:y1 + h_crop, x1:x1 + w_crop] += 1
        return preds / count, {}

    def inference_logits(self, img):
        """Raw (pre-softmax) logits at input size, slide/whole per
        ``test_cfg.mode``: the quantity view finalization rescales
        before the softmax (``encoder_decoder.py:284-310``)."""
        if (self.test_cfg or {}).get('mode', 'whole') == 'slide':
            return self.slide_inference(img)
        return self.whole_inference(img)

    def inference(self, img, rescale_size=None, flip: bool = False,
                  flip_direction: str = 'horizontal'):
        """softmax probs with optional rescale + flip-undo
        (``encoder_decoder.py:284-327``)."""
        seg_logit, states = self.inference_logits(img)
        if rescale_size is not None and \
                tuple(rescale_size) != tuple(seg_logit.shape[2:]):
            seg_logit = resize(seg_logit, size=rescale_size,
                               mode='bilinear',
                               align_corners=self.align_corners)
        output = torch.softmax(seg_logit, dim=1)
        if flip:
            dirs = flip_direction if isinstance(flip_direction,
                                                (list, tuple)) \
                else [flip_direction]
            for d in dirs:
                output = torch.flip(output,
                                    dims=(3 if d == 'horizontal' else 2,))
        return output, states

    def simple_test_logits(self, img):
        probs, states = self.inference(img)
        return probs.argmax(dim=1), probs, states
