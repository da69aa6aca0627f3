"""EncoderDecoder segmentor on NCHW tensors, inference half (port of
``pfst_tpu/models/segmentors/encoder_decoder.py``).

Attributes ``backbone``, ``decode_head`` and ``auxiliary_head`` give the
rsiseg state-dict prefixes. Inference follows
``encoder_decoder.py:72-84,220-327``: ``encode_decode`` resizes the head
logits to the input, ``slide_inference`` averages overlapping windows
over the same grid as the JAX ``fori_loop`` (here a plain loop), and
``inference`` softmaxes after the rescale. ``forward_train`` comes with
the training path.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Union

import torch
import torch.nn as nn

from ...ops import resize
from ..builder import SEGMENTORS, build_backbone, build_head, build_neck
from ..utils.layers import init_conv_


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
        at scale 1, shift 0, running mean 0 and variance 1."""
        with torch.no_grad():
            for name, m in self.named_modules():
                if isinstance(m, nn.Conv2d):
                    if name.endswith('conv_seg'):
                        m.weight.normal_(0.0, 0.01, generator=generator)
                    else:
                        init_conv_(m.weight, generator)
                    if m.bias is not None:
                        m.bias.zero_()
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
            aux = self.auxiliary_head
            aux = [] if aux is None else (
                aux if isinstance(aux, nn.ModuleList) else [aux])
            aux_logits = tuple(h(feats)[0] for h in aux)
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
