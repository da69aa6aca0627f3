"""EncoderDecoder segmentor on NCHW tensors (port of
``pfst_tpu/models/segmentors/encoder_decoder.py``).

Attributes ``backbone``, ``decode_head`` and ``auxiliary_head`` give the
rsiseg state-dict prefixes. Inference follows
``encoder_decoder.py:72-84,220-327``: ``encode_decode`` resizes the head
logits to the input, ``slide_inference`` averages overlapping windows
over the same grid as the JAX ``fori_loop`` (here a plain loop), and
``inference`` softmaxes after the rescale. ``forward_train``
(``encoder_decoder.py:140-241``) is the plain-head branch: decode and
auxiliary losses under the ``decode.`` / ``aux.`` prefixes, in fp32.
The K-Net, EncNet, DAHead and PointRend branches and the OHEM sampler
are not ported and raise.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Union

import torch
import torch.nn as nn

from ...ops import resize
from ...utils.misc import add_prefix
from ..builder import (SEGMENTORS, build_backbone, build_head, build_loss,
                       build_neck)
from ..losses.accuracy import accuracy
from ..utils.layers import init_conv_


def _head_losses(head, loss_fns, seg_logit, seg_label, seg_weight=None):
    """Logits resized to the label size in fp32, each loss, then the pixel
    accuracy (``encoder_decoder.py:26-51``)."""
    seg_logit = resize(seg_logit.float(), size=seg_label.shape[1:],
                       mode='bilinear', align_corners=head.align_corners)
    loss = {}
    for loss_fn in loss_fns:
        name = loss_fn.loss_name
        val = loss_fn(seg_logit, seg_label, weight=seg_weight,
                      ignore_index=head.ignore_index)
        loss[name] = loss[name] + val if name in loss else val
    loss['acc_seg'] = accuracy(seg_logit, seg_label,
                               ignore_index=head.ignore_index)
    return loss


def _build_losses(loss_cfg):
    if loss_cfg is None:
        loss_cfg = {'type': 'CrossEntropyLoss', 'use_sigmoid': False,
                    'loss_weight': 1.0}
    if isinstance(loss_cfg, (list, tuple)):
        return tuple(build_loss(c) for c in loss_cfg)
    return (build_loss(loss_cfg),)


def _check_plain_head(head):
    """The training branches the port does not have yet."""
    for attr, what in (('all_stage_logits', 'K-Net stage losses'),
                       ('use_se_loss', 'the EncNet SE loss'),
                       ('branch_loss_names', 'the DAHead branch losses'),
                       ('point_losses', 'the PointRend point loss'),
                       ('transform_targets', 'STDC boundary targets'),
                       ('sampler', 'the OHEM pixel sampler')):
        if getattr(head, attr, None):
            raise NotImplementedError(f'forward_train: {what} are not '
                                      f'ported')


@SEGMENTORS.register_module()
class EncoderDecoder(nn.Module):

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
        self.neck = build_neck(neck) if neck else None
        self.decode_head = build_head(decode_head)
        if isinstance(auxiliary_head, (list, tuple)):
            self.auxiliary_head = nn.ModuleList(
                build_head(a) for a in auxiliary_head)
        elif auxiliary_head is not None:
            self.auxiliary_head = build_head(auxiliary_head)
        else:
            self.auxiliary_head = None
        self.train_cfg = train_cfg
        self.test_cfg = test_cfg
        self._decode_losses = _build_losses(decode_head.get('loss_decode'))
        aux_cfgs = [] if auxiliary_head is None else (
            list(auxiliary_head) if isinstance(auxiliary_head, (list, tuple))
            else [auxiliary_head])
        self._aux_losses = tuple(_build_losses(a.get('loss_decode'))
                                 for a in aux_cfgs)
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f'dtype must be float32 or bfloat16, got {dtype}')
        self.dtype = dtype

    @property
    def align_corners(self):
        return self.decode_head.align_corners

    @property
    def num_classes(self):
        return self.decode_head.num_classes

    def init_weights(self, generator: torch.Generator):
        """The JAX package's initializers, drawn from ``generator``:
        convs truncated-normal fan-out (``layers.py:126-127``), the
        classifiers normal(0.01) (``base.py:55``), biases zero, norms
        at scale 1, shift 0, running mean 0 and variance 1. A child with
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

    def forward(self, img):
        """Full forward returning everything downstream consumers need."""
        with self._autocast(img):
            feats = self.extract_feat(img)
            logits, decoded = self.decode_head(feats)[:2]
            aux_logits = tuple(h(feats)[0] for h in self._aux_heads())
        return {'feats': feats, 'seg_logits': logits,
                'decoded_features': decoded, 'aux_logits': aux_logits}

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
        (``encoder_decoder.py:140-241``, plain-head branch). Dropout runs
        when the module is in train mode. Returns ``(losses, states)``,
        ``states = {seg_logits (head resolution), decoded_features,
        features}``."""
        heads = [self.decode_head, *self._aux_heads()]
        for head in heads:
            _check_plain_head(head)
        gt = gt_semantic_seg.long()
        out = self(img)
        losses = add_prefix(_head_losses(self.decode_head,
                                         self._decode_losses,
                                         out['seg_logits'], gt, seg_weight),
                            'decode')
        for i, (head, aux_logit) in enumerate(zip(heads[1:],
                                                  out['aux_logits'])):
            prefix = 'aux' if len(heads) == 2 else f'aux_{i}'
            losses.update(add_prefix(
                _head_losses(head, self._aux_losses[i], aux_logit, gt,
                             seg_weight), prefix))
        states = {'seg_logits': out['seg_logits'],
                  'decoded_features': out['decoded_features'],
                  'features': out['feats']}
        return losses, states

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
