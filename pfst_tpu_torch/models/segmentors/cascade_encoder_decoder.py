"""CascadeEncoderDecoder on NCHW tensors (port of
``pfst_tpu/models/segmentors/cascade_encoder_decoder.py``; the OCRNet and
PointRend defs).

``decode_head`` is a list of stages in a ``ModuleList``: the first runs
on the features alone, every later one, built with ``prev_stage=True``
(so it makes no prior of its own, as the JAX tree has none), also gets
the previous stage's logits (``prev_logits``). Inference and
``decoded_features`` are the last stage's. Training losses carry the
``decode_{i}.`` prefixes; a stage with ``point_losses`` (PointRend) is
trained by its point loss on the previous stage's coarse logits
(``decode_{i}.pointloss_ce``, ``decode_{i}.acc_point``, ``:109-127``).
The auxiliary heads work as ``EncoderDecoder``'s.
"""
from __future__ import annotations

import torch.nn as nn

from ...ops import resize
from ...utils.misc import add_prefix
from ..builder import SEGMENTORS, build_head
from .encoder_decoder import (EncoderDecoder, _at_fed_width, _build_losses,
                              _head_losses, _point_losses)


@SEGMENTORS.register_module()
class CascadeEncoderDecoder(EncoderDecoder):

    def __init__(self, num_stages: int = 2, **kwargs):
        if len(kwargs['decode_head']) != num_stages:
            raise ValueError(f'{num_stages} stages, but '
                             f'{len(kwargs["decode_head"])} decode heads')
        super().__init__(**kwargs)

    def _build_decode_head(self, cfgs, widths):
        return nn.ModuleList(
            build_head({**_at_fed_width(cfg, widths),
                        **({'prev_stage': True} if i else {})})
            for i, cfg in enumerate(cfgs))

    def _build_decode_losses(self, cfgs):
        return tuple(_build_losses(cfg.get('loss_decode')) for cfg in cfgs)

    @property
    def align_corners(self):
        return self.decode_head[-1].align_corners

    @property
    def num_classes(self):
        return self.decode_head[-1].num_classes

    def _cascade(self, feats):
        """Every stage's logits and the last stage's features."""
        logits, decoded = self.decode_head[0](feats)[:2]
        stage_logits = [logits]
        for head in self.decode_head[1:]:
            logits, decoded = head(feats, prev_logits=logits)[:2]
            stage_logits.append(logits)
        return stage_logits, decoded

    def forward(self, img):
        with self._autocast(img):
            feats = self.extract_feat(img)
            stage_logits, decoded = self._cascade(feats)
            aux_logits = tuple(h(feats)[0] for h in self._aux_heads())
        return {'feats': feats, 'seg_logits': stage_logits[-1],
                'stage_logits': stage_logits, 'decoded_features': decoded,
                'aux_logits': aux_logits, 'branch_logits': ()}

    def encode_decode(self, img):
        with self._autocast(img):
            feats = self.extract_feat(img)
            stage_logits, decoded = self._cascade(feats)
            out = resize(stage_logits[-1], size=img.shape[2:],
                         mode='bilinear', align_corners=self.align_corners)
        states = {'feats': feats, 'decoded_features': decoded,
                  'seg_logits': out, 'head_logits': stage_logits[-1]}
        return out, states

    def forward_train(self, img, gt_semantic_seg, seg_weight=None):
        """Each stage's losses under ``decode_{i}``, the auxiliary heads'
        under ``aux`` or ``aux_{i}``; returns ``(losses, states)`` as
        ``EncoderDecoder.forward_train``."""
        gt = gt_semantic_seg.long()
        out = self(img)
        losses = {}
        for i, (head, logits) in enumerate(zip(self.decode_head,
                                               out['stage_logits'])):
            if hasattr(head, 'point_losses'):
                with self._autocast(img):
                    points = head.point_losses(
                        out['feats'], gt,
                        coarse_logits=out['stage_logits'][i - 1])
                stage = _point_losses(head, self._decode_losses[i], *points)
            else:
                stage = _head_losses(head, self._decode_losses[i], logits,
                                     gt, seg_weight)
            losses.update(add_prefix(stage, f'decode_{i}'))
        losses.update(self._aux_head_losses(out['aux_logits'], gt,
                                            seg_weight))
        states = {'seg_logits': out['seg_logits'],
                  'decoded_features': out['decoded_features'],
                  'features': out['feats']}
        return losses, states
