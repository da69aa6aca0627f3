"""Domain-adaptation segmentors (port of
``pfst_tpu/models/segmentors/domain_adaptor.py``; mirrors rsiseg's
``domain_adaptor*.py`` / ``fmda_adaptor*.py``).

Each step takes a paired source and target batch: ``dom1_`` / ``dom2_``
keys (``MultiDomainDataset``, the family's input) or ``img`` /
``target_*`` (``UDADataset``).

* ``DomainAdaptor``: supervised training on both domains, the target
  total scaled by ``weight_trg``;
* ``DomainAdaptorAdv``: adversarial entropy alignment with a
  discriminator and its own optimizer;
* ``DomainAdaptorV2``: the source CE plus tensors-dict aux losses over
  both domains' outputs;
* ``FMDAAdaptor`` / ``FMDAAdaptorV2``: ``DomainAdaptor`` plus a
  similarity loss over feature (V2: similarity) maps that the batch
  carries.

Each is an orchestrator with the UDA algorithms' API: ``init_state`` /
``make_train_step``, the student in ``state.student``. The JAX file merges
the two student passes into one vmapped pass whose running statistics
recompose to those of the sequential pair (``domain_adaptor.py:141-173``);
here the passes run one after the other, source then target, as the
reference runs them. A step's dropout is seeded from its generator.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.nn as nn

from ...ops import resize
from ...parallel import (average_buffers, average_gradients,
                         average_log_vars, sync_bn_group)
from ...utils.misc import add_prefix
from ..builder import (SEGMENTORS, build_discriminator, build_loss,
                       build_segmentor)
from ..uda.pfgst import parse_losses
from ..uda.uda_decorator import UDATrainState, maybe_normalize_images
from ..utils.pfst_transforms import transform_by_metas

_REPLAY_KEYS = ('rotate_k', 'flip_vertical', 'flip_horizontal')


@dataclass
class AdvTrainState(UDATrainState):
    """The adversarial adaptor's state (``AdvTrainState``,
    ``domain_adaptor.py:38-45``): the discriminator holds
    ``disc_params``, ``disc_optimizer`` holds ``disc_opt_state``."""
    discriminator: Optional[nn.Module] = None
    disc_optimizer: object = None


def _first(batch: dict, *keys):
    for k in keys:
        if batch.get(k) is not None:
            return batch[k]
    return None


def domain_batch(batch: dict):
    """(img_src, gt_src, img_trg, gt_trg or None) under either key
    convention (``domain_adaptor.py:126-134``)."""
    return (_first(batch, 'dom1_img', 'img'),
            _first(batch, 'dom1_gt_semantic_seg', 'gt_semantic_seg').long(),
            _first(batch, 'dom2_img', 'target_img'),
            _first(batch, 'dom2_gt_semantic_seg', 'target_gt_semantic_seg'))


def _as_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _encoder_decoder_cfg(cfg: dict) -> dict:
    """The student's ``EncoderDecoder`` config from an adaptor's config
    (``domain_adaptor.py:51-61``)."""
    return dict(type='EncoderDecoder', backbone=cfg['backbone'],
                decode_head=cfg['decode_head'], neck=cfg.get('neck'),
                auxiliary_head=cfg.get('auxiliary_head'),
                train_cfg=cfg.get('train_cfg'), test_cfg=cfg.get('test_cfg'),
                pretrained=cfg.get('pretrained'))


def student_cfg(model_cfg: dict) -> dict:
    """The segmentor config of a ``cfg.model``: for a domain-adaptor type
    its student's, else ``model_cfg`` itself. Serving and evaluation build
    the student so."""
    cls = SEGMENTORS.get(model_cfg.get('type'))
    if isinstance(cls, type) and issubclass(cls, _DomainAdaptorBase):
        return _encoder_decoder_cfg(model_cfg)
    return model_cfg


class _DomainAdaptorBase:
    """Construction, the train state and the step's frame
    (``domain_adaptor.py:48-83``)."""

    def __init__(self, device='cuda', **cfg):
        self.cfg = cfg
        self.device = torch.device(device)
        self.model_cfg = _encoder_decoder_cfg(cfg)
        self.num_classes = cfg['decode_head']['num_classes']
        self.weight_trg = cfg.get('weight_trg', 1.0)
        self.aux_losses = [build_loss(dict(c))
                           for c in _as_list(cfg.get('aux_losses'))]

    def _student(self, generator: torch.Generator) -> nn.Module:
        """The segmentor, with the JAX package's initializers drawn from
        ``generator`` on the CPU, in train mode on ``self.device``."""
        student = build_segmentor(copy.deepcopy(self.model_cfg))
        return student.init_weights(generator).to(self.device).train()

    def init_state(self, generator: torch.Generator, tx) -> UDATrainState:
        """The student and its optimizer (``tx``, a ``build_optimizer``
        factory); no teacher."""
        if isinstance(tx, dict):
            raise ValueError(f'{type(self).__name__} takes one optimizer; a '
                             f'dict of them is DomainAdaptorAdv\'s')
        student = self._student(generator)
        return UDATrainState(student=student, teacher=None,
                             optimizer=tx(student), step=0)

    def forward_train(self, state, batch: dict):
        """The step's total loss with its graph to the student, and the
        log vars."""
        raise NotImplementedError

    def make_train_step(self, mean, std, collect_vis: bool = False,
                        group=None):
        """The train step ``(state, batch, generator) -> (state, log_vars)``
        (``domain_adaptor.py:118-215``): the losses, backward, optimizer
        step and ``step + 1``, in place on ``state``. ``batch`` holds NCHW
        tensors on the state's device (images normalized, or uint8 /
        float16 on the 0-255 scale); ``log_vars`` are 0-dim tensors on the
        device. With ``collect_vis`` the step returns ``(state, log_vars,
        {})``: the JAX adaptors give no visualisation states
        (``domain_adaptor.py:212``). With a process ``group``, one
        replica's step: ``SyncBN`` spans the group, and the gradients, the
        log vars and, after the optimizer step, the running statistics are
        averaged over it (``domain_adaptor.py:202-205``)."""

        def step_fn(state, batch: dict, generator: torch.Generator):
            batch = maybe_normalize_images(batch, mean, std)
            seed = int(torch.randint(2**62, (), generator=generator))
            img = domain_batch(batch)[0]
            devices = [img.device] if img.device.type == 'cuda' else []
            state.student.train()
            with torch.random.fork_rng(devices=devices), \
                    sync_bn_group(group):
                torch.manual_seed(seed)
                total, log_vars = self.forward_train(state, batch)
            state.optimizer.zero_grad()
            total.backward()
            average_gradients(state.optimizer.params, group)
            state.optimizer.step()
            average_buffers(state.student, group)
            state.step += 1
            log_vars = {k: v.detach() for k, v in log_vars.items()}
            log_vars['loss'] = total.detach()
            log_vars = average_log_vars(log_vars, group)
            return (state, log_vars, {}) if collect_vis else (state, log_vars)

        return step_fn


@SEGMENTORS.register_module()
class DomainAdaptor(_DomainAdaptorBase):
    """Supervised training on both domains (``domain_adaptor.py:86-215``).

    ``weight_trg`` scales the target total once; the log vars carry the
    unscaled per-key values (the reference scales its ``loss_ce`` keys in
    place and logs them scaled, which for the CE-only heads of every
    shipped config gives the same total). Without target labels the step
    is the source's alone."""

    def __init__(self, **cfg):
        if cfg.get('aux_losses') and type(self) is DomainAdaptor:
            raise ValueError('plain DomainAdaptor takes no aux_losses '
                             '- use DomainAdaptorV2')
        super().__init__(**cfg)

    def forward_train(self, state, batch):
        student = state.student
        img_src, gt_src, img_trg, gt_trg = domain_batch(batch)
        l_src, _ = student.forward_train(img_src, gt_src)
        total, log_vars = parse_losses(add_prefix(l_src, 'src'))
        if gt_trg is not None:
            l_trg, _ = student.forward_train(img_trg, gt_trg.long())
            t_trg, lv = parse_losses(add_prefix(l_trg, 'trg'))
            log_vars.update(lv)
            total = total + t_trg * self.weight_trg
        return total, log_vars


@SEGMENTORS.register_module()
class DomainAdaptorAdv(_DomainAdaptorBase):
    """Adversarial entropy alignment (``domain_adaptor.py:218-396``).

    One generator forward: the source supervised pass and the target
    forward. Then the discriminator updates first, on the detached
    tensors; then the generator's adversarial loss is taken against the
    updated discriminator, frozen (its parameters take no gradient), and
    its gradient reaches the generator through the discriminator's input.
    The discriminator updates every step (rsiseg's ``disc_steps`` gate is
    dead code). ``loss`` is ``gen_total + disc_total``, where the
    reference logs whatever its last ``_parse_losses`` returned."""

    def __init__(self, discriminator=None, disc_losses=None,
                 gen_losses=None, **cfg):
        if cfg.get('aux_losses'):
            raise ValueError('DomainAdaptorAdv does not support aux_losses '
                             '- use gen_losses/disc_losses (or '
                             'DomainAdaptorV2)')
        super().__init__(**cfg)
        self.disc_cfg = dict(discriminator or dict(
            type='FCDiscriminator', num_in_channels=self.num_classes))
        self.disc_losses = [build_loss(dict(c))
                            for c in _as_list(disc_losses)]
        self.gen_losses = [build_loss(dict(c)) for c in _as_list(gen_losses)]

    def init_state(self, generator: torch.Generator, tx) -> AdvTrainState:
        """The student, the discriminator (flax's initializers, drawn
        after the student's) and an optimizer for each. A dict ``tx`` is
        read by its keys ``model`` / ``generator`` / ``backbone`` (else its
        first) and ``discriminator`` (else its last), the reference's
        optimizer dict; one factory serves both."""
        if isinstance(tx, dict):
            tx_model = tx.get('model') or tx.get('generator') or \
                tx.get('backbone') or list(tx.values())[0]
            tx_disc = tx.get('discriminator') or list(tx.values())[-1]
        else:
            tx_model = tx_disc = tx
        student = self._student(generator)
        disc = build_discriminator(self.disc_cfg).init_weights(generator)
        disc = disc.to(self.device).train()
        return AdvTrainState(student=student, teacher=None,
                             optimizer=tx_model(student), step=0,
                             discriminator=disc,
                             disc_optimizer=tx_disc(disc))

    def make_train_step(self, mean, std, collect_vis: bool = False,
                        group=None):
        """The train step (``domain_adaptor.py:280-396``), in place on
        ``state``: both optimizers step, the discriminator's first. With
        ``collect_vis`` it returns ``(state, log_vars, {})``
        (``domain_adaptor.py:393``). With a process ``group`` each
        optimizer steps on gradients averaged over it (the
        discriminator's, ``:353-354``, then the generator's, ``:380-383``),
        and the log vars and the student's running statistics are
        averaged too."""

        def step_fn(state: AdvTrainState, batch: dict,
                    generator: torch.Generator):
            batch = maybe_normalize_images(batch, mean, std)
            img_src, gt_src, img_trg, _ = domain_batch(batch)
            seed = int(torch.randint(2**62, (), generator=generator))
            devices = [img_src.device] if img_src.device.type == 'cuda' \
                else []
            student, disc = state.student, state.discriminator
            student.train()
            with torch.random.fork_rng(devices=devices), \
                    sync_bn_group(group):
                torch.manual_seed(seed)
                l_src, st_src = student.forward_train(img_src, gt_src)
                out_trg = student(img_trg)
            tensors = dict(img_src=img_src, img_trg=img_trg,
                           logits_src=st_src['seg_logits'],
                           logits_trg=out_trg['seg_logits'],
                           x_src=st_src['features'], x_trg=out_trg['feats'])
            total, log_vars = parse_losses(l_src)

            # the discriminator first, on the detached tensors
            det = {k: tuple(x.detach() for x in v)
                   if isinstance(v, (tuple, list)) else v.detach()
                   for k, v in tensors.items()}
            d_total, d_log = 0.0, {}
            for loss in self.disc_losses:
                t, lv = parse_losses(loss(disc, det))
                d_total = d_total + t
                d_log.update(lv)
            state.disc_optimizer.zero_grad()
            if isinstance(d_total, torch.Tensor):
                d_total.backward()
            average_gradients(state.disc_optimizer.params, group)
            state.disc_optimizer.step()

            # the generator against the updated discriminator, frozen
            frozen = [p for p in disc.parameters() if p.requires_grad]
            for p in frozen:
                p.requires_grad_(False)
            try:
                for loss in self.gen_losses:
                    t, lv = parse_losses(loss(disc, tensors))
                    total = total + t
                    log_vars.update(lv)
            finally:
                for p in frozen:
                    p.requires_grad_(True)
            state.optimizer.zero_grad()
            total.backward()
            average_gradients(state.optimizer.params, group)
            state.optimizer.step()
            average_buffers(state.student, group)
            state.step += 1
            log_vars.update(d_log)
            log_vars = {k: v.detach() for k, v in log_vars.items()}
            log_vars['loss'] = total.detach() + (
                d_total.detach() if isinstance(d_total, torch.Tensor)
                else d_total)
            log_vars = average_log_vars(log_vars, group)
            return (state, log_vars, {}) if collect_vis else (state, log_vars)

        return step_fn


@SEGMENTORS.register_module()
class DomainAdaptorV2(DomainAdaptor):
    """The aux-loss variant (``domain_adaptor.py:399-485``): the source
    CE, no target CE, and the aux losses over the tensors of the source
    pass (``logits_src`` not detached) and a plain target forward
    (``logits_trg``, ``logits_trg_aux``, ``x_trg``). ``weight_trg`` and
    ``aux_seg_net`` are accepted and unused, as in the reference."""

    def __init__(self, aux_seg_net=None, **cfg):
        del aux_seg_net
        super().__init__(**cfg)

    def forward_train(self, state, batch):
        student = state.student
        img_src, gt_src, img_trg, gt_trg = domain_batch(batch)
        l_src, st_src = student.forward_train(img_src, gt_src)
        total, log_vars = parse_losses(l_src)
        out_trg = student(img_trg)
        tensors = dict(
            img_src=img_src, img_trg=img_trg, gt_src=gt_src, gt_trg=gt_trg,
            x_src=st_src['features'], x_trg=out_trg['feats'],
            logits_src=st_src['seg_logits'],
            logits_trg=out_trg['seg_logits'],
            logits_trg_aux=out_trg['aux_logits'])
        aux: Dict[str, torch.Tensor] = {}
        for loss in self.aux_losses:
            aux.update(loss(tensors) or {})
        if aux:
            a_total, lv = parse_losses(aux)
            log_vars.update(lv)
            total = total + a_total
        return total, log_vars


@SEGMENTORS.register_module()
class FMDAAdaptor(DomainAdaptor):
    """``DomainAdaptor`` plus ``loss_sim_feat`` over maps the batch carries
    (``domain_adaptor.py:488-603``): the tensors whose keys hold
    ``feat_key_filter``, the replay metas left out, sorted by key. Each is
    nearest-resized to ``pre_feat_shape`` where it is set, and replayed by
    the target's ``rotate_k`` / ``flip_*`` metas (``dom2_`` keys first)
    where the batch has them; the loss takes the list and the target's
    head logits. A target without labels trains against an all-255 map.
    Losses are prefixed ``src.dec`` / ``trg.dec``."""

    feat_key_filter = 'feat'   # raw features (fmda_adaptor.py:197)

    def __init__(self, **cfg):
        super().__init__(**cfg)
        self.pre_feat_shape = cfg.get('pre_feat_shape')
        self.loss_sim_feat = build_loss(cfg['loss_sim_feat']) \
            if cfg.get('loss_sim_feat') else None

    def sim_keys(self, batch):
        return sorted(k for k, v in batch.items()
                      if self.feat_key_filter in k and
                      isinstance(v, torch.Tensor) and
                      not any(m in k for m in ('rotate', 'flip')))

    def forward_train(self, state, batch):
        student = state.student
        img_src, gt_src, img_trg, gt_trg = domain_batch(batch)
        l_src, _ = student.forward_train(img_src, gt_src)
        total, log_vars = parse_losses(add_prefix(l_src, 'src.dec'))
        trg_labels = gt_trg.long() if gt_trg is not None else torch.full(
            (img_trg.shape[0], *img_trg.shape[2:]), 255, dtype=torch.long,
            device=img_trg.device)
        l_trg, st_trg = student.forward_train(img_trg, trg_labels)
        t_trg, lv = parse_losses(add_prefix(l_trg, 'trg.dec'))
        log_vars.update(lv)
        total = total + t_trg * self.weight_trg
        keys = self.sim_keys(batch)
        if self.loss_sim_feat is None or not keys:
            return total, log_vars
        metas = {}
        for k in _REPLAY_KEYS:
            meta = _first(batch, f'dom2_{k}', k)
            if meta is not None:
                metas[k] = meta
        maps = []
        for k in keys:
            data = batch[k]
            if self.pre_feat_shape is not None:
                data = resize(data, size=tuple(self.pre_feat_shape),
                              mode='nearest')
            if metas:
                data = transform_by_metas(data, metas)
            maps.append(data)
        l_sim, _ = self.loss_sim_feat(maps, st_trg['seg_logits'])
        s_total, lv = parse_losses(l_sim)
        log_vars.update(lv)
        return total + s_total, log_vars


@SEGMENTORS.register_module()
class FMDAAdaptorV2(FMDAAdaptor):
    """Precomputed similarity maps (``sim_feat`` keys) for
    ``FeatSimLossV2`` (``domain_adaptor.py:606-611``)."""

    feat_key_filter = 'sim_feat'
