"""PFGST: pseudo-features guided self-training (port of
``pfst_tpu/models/uda/pfgst.py``).

One training iteration: EMA update of the teacher, teacher forward on the
target batch, pseudo-labels with the ``thre_type`` confidence weight,
ClassMix with the strong view and strong augmentation, the source and
the mixed student passes one after the other (BN running statistics
chained source -> mixed; the JAX file's merged pass is proven equal to
this by ``tests/test_uda_variants.py::test_merged_student_passes``), the
PFGST losses, and the optimizer step. ``teacher_and_mix`` and
``forward_train(premix=...)`` are separable as in the JAX file. All the
step's random numbers come from one ``torch.Generator``
(``sample_draws``), drawn on the CPU, so the same generator gives the
same step on the card and on the CPU.

The variant hooks of the JAX file's subclasses (DACS, PFST, PGST, FMDA)
are class attributes: ``mix_view``, the target view ClassMix blends;
``target_self_training`` with its ``self_training_view``, training on
the target view itself against the pseudo-labels (losses prefixed
``trg``); ``mix_ema_feat_level``, PGST's blend of the teacher's feature
map with the student's source map; ``mix_feat_teacher_forward``,
PGSTMixFeat's second teacher forward on a weak mix. The config adds
DACS's feature distance to a frozen copy of the initial student
(``imnet_feature_dist_lambda``) and the backbone's gradient norm in the
log vars (``print_grad_magnitude``).

Loss accounting is ``parse_losses``: every key holding ``loss`` sums into
the total; every scalar is logged. With ``collect_vis`` the step also
returns the visualisation states of the JAX step (``pfgst.py:496-516``):
the ``vis|`` entries of the aux losses, and ``vis|seg_mask_src`` /
``vis|seg_mask_mix``, each ``(image, labels, head-resolution argmax)``.
They stay tensors on the step's device, in the port's NCHW layout, and
the step waits for nothing to make them.
"""
from __future__ import annotations

from typing import Dict

import torch

from ...ops import resize
from ...parallel import (average_buffers, average_gradients,
                         average_log_vars, gradient_norm, is_global_batch,
                         sync_bn_group)
from ...utils.misc import add_prefix
from ..builder import UDA, build_loss
from ..losses.utils import masked_mean
from ..utils.dacs_transforms import (get_class_masks, sample_strong_draws,
                                     strong_transform)
from .uda_decorator import (UDADecorator, UDATrainState,
                            batch_stats_forward, maybe_normalize_images)


def parse_losses(losses: Dict[str, torch.Tensor]):
    """Sum the ``*loss*`` keys into the total; every entry, reduced to its
    mean, goes to the log vars (``pfgst.py:33-44``)."""
    log_vars = {}
    total = 0.0
    for name, value in losses.items():
        if name.startswith('vis|'):
            continue
        value = value.mean()
        log_vars[name] = value
        if 'loss' in name:
            total = total + value
    return total, log_vars


@UDA.register_module()
class PFGST(UDADecorator):
    """The PFST paper's algorithm (config surface of ``pfgst.py:77-110``)."""

    # the target view ClassMix blends (``pfgst.py:112-115``): the
    # pipeline's strong view, or 'target', the plain one (DACS, FMDAMix)
    mix_view = 'strong_aug'
    # PGST (``pfgst.py:119-122``): the level whose teacher map is blended
    # with the student's detached source map before the aux losses
    mix_ema_feat_level = None
    # FMDA / PGSTTRG (``pfgst.py:123-131``): train on the target view
    # itself instead of ClassMix; 'jitter_plain' jitters and blurs the
    # plain view in the step (FMDA), 'pipeline_strong' takes the
    # pipeline's strong view as it is (PGSTTRG)
    target_self_training = False
    self_training_view = 'jitter_plain'
    # PGSTMixFeat: a second teacher forward on the weak mix feeds the aux
    # losses
    mix_feat_teacher_forward = False

    def __init__(self, **cfg):
        super().__init__(**cfg)
        self.alpha = cfg['alpha']
        self.pseudo_threshold = cfg['pseudo_threshold']
        self.psweight_ignore_top = cfg.get('pseudo_weight_ignore_top', 0)
        self.psweight_ignore_bottom = cfg.get(
            'pseudo_weight_ignore_bottom', 0)
        self.fdist_lambda = cfg.get('imnet_feature_dist_lambda', 0)
        self.enable_fdist = self.fdist_lambda > 0
        self.fdist_classes = cfg.get('imnet_feature_dist_classes')
        self.mix = cfg.get('mix', 'class')
        self.blur = cfg.get('blur', True)
        self.color_jitter_s = cfg.get('color_jitter_strength', 0.2)
        self.color_jitter_p = cfg.get('color_jitter_probability', 0.2)
        self.trg_loss_weight = cfg.get('trg_loss_weight', 1.0)
        self.use_decoded_feats = cfg.get('use_decoded_feats', False)
        self.thre_type = cfg.get('thre_type', 'all')
        self.strong_aug_denorm_type = cfg.get('strong_aug_denorm_type',
                                              'mean_std')
        self.apply_no_mix = cfg.get('apply_no_mix', False)
        self.print_grad_magnitude = cfg.get('print_grad_magnitude', False)
        if self.mix != 'class':
            raise ValueError(f'PFGST mixes by class, got mix={self.mix!r}')
        if self.thre_type not in ('all', 'part'):
            raise ValueError(f'unknown thre_type {self.thre_type!r}')
        if self.mix_view not in ('strong_aug', 'target') or \
                self.self_training_view not in ('jitter_plain',
                                                'pipeline_strong'):
            raise ValueError(f'unknown view {self.mix_view!r} / '
                             f'{self.self_training_view!r}')
        aux_losses = cfg.get('aux_losses') or []
        if not isinstance(aux_losses, (list, tuple)):
            aux_losses = [aux_losses]
        self.aux_losses = [build_loss(dict(c)) for c in aux_losses]

    # ------------------------------------------------------------------
    def sample_draws(self, generator: torch.Generator,
                     batch_size: int) -> dict:
        """Every random number of one step, on the CPU: the ClassMix and
        strong-augmentation draws and the seed of the student passes'
        dropout."""
        draws = sample_strong_draws(generator, batch_size, self.num_classes,
                                    self.color_jitter_s, self.blur)
        draws['dropout_seed'] = int(torch.randint(
            2**62, (), generator=generator))
        return draws

    @torch.no_grad()
    def teacher_forward(self, state: UDATrainState, target_img):
        """Teacher forward (``pfgst.py:173-187``): batch-statistics BN,
        running statistics untouched, no dropout."""
        with batch_stats_forward(state.teacher) as teacher:
            ema_logits, ema_states = teacher.encode_decode(target_img)
        ema_feats = ema_states['decoded_features'] \
            if self.use_decoded_feats else ema_states['feats']
        return ema_logits, ema_feats

    @torch.no_grad()
    def teacher_and_mix(self, state: UDATrainState, batch: dict,
                        draws: dict, mean, std, teacher_out=None) -> dict:
        """The gradient-free half of the step (``pfgst.py:189-324``):
        teacher forward (unless ``teacher_out`` gives it), pseudo-labels
        and their weight, then ClassMix of the source with the
        ``mix_view`` target view and strong augmentation, or with
        ``target_self_training`` the target view the student trains on."""
        img = batch['img']
        gt = batch['gt_semantic_seg'].long()
        target_img = batch['target_img']
        target_strong = batch.get('target_img_strong_aug', target_img)
        b, _, h, w = img.shape
        if teacher_out is None:
            teacher_out = self.teacher_forward(state, target_img)
        ema_logits, ema_feats = teacher_out

        ema_softmax = torch.softmax(ema_logits.float(), dim=1)
        pseudo_prob = ema_softmax.amax(dim=1)                # (B, H, W)
        pseudo_label = ema_softmax.argmax(dim=1)
        ps_large_p = pseudo_prob >= self.pseudo_threshold
        if self.thre_type == 'all':
            pseudo_weight = torch.full_like(pseudo_prob, 1.0) * \
                ps_large_p.float().mean()
        else:
            pseudo_weight = ps_large_p.float()
        rows = torch.arange(h, device=img.device)[None, :, None]
        if self.psweight_ignore_top > 0:
            pseudo_weight = torch.where(rows < self.psweight_ignore_top,
                                        0.0, pseudo_weight)
        if self.psweight_ignore_bottom > 0:
            pseudo_weight = torch.where(
                rows >= h - self.psweight_ignore_bottom, 0.0, pseudo_weight)

        if self.target_self_training or self.apply_no_mix:
            mix_masks = torch.zeros((b, h, w), device=img.device)
            trg_img = target_img
        else:
            mix_masks = get_class_masks(draws['class_scores'], gt,
                                        self.num_classes)
            trg_img = target_strong if self.mix_view == 'strong_aug' \
                else target_img

        def transform(mask, pair, labels):
            return strong_transform(
                draws, mask, data_pair=pair, target_pair=labels,
                color_jitter_p=self.color_jitter_p, mean=mean, std=std,
                denorm_type=self.strong_aug_denorm_type)

        pl = pseudo_label.float()
        if self.target_self_training and \
                self.self_training_view == 'pipeline_strong':
            # PGSTTRG (``pfgst.py:267-272``): the pipeline's strong view as
            # it is, the raw pseudo-labels and weight
            mixed_img, mixed_lbl, mixed_w = target_strong, pseudo_label, \
                pseudo_weight
        elif self.target_self_training:
            # FMDA (``pfgst.py:273-290``): the plain view jittered and
            # blurred on the step's draws, the raw pseudo-labels and weight
            mixed_img, mixed_lbl = transform(
                mix_masks, (target_img, target_img), (pl, pl))
            mixed_w = pseudo_weight
        else:
            mixed_img, mixed_lbl = transform(
                mix_masks, (img, trg_img), (gt.float(), pl))
            _, mixed_w = strong_transform(
                draws, mix_masks,
                target_pair=(torch.ones_like(pseudo_weight), pseudo_weight))
        out = dict(ema_logits=ema_logits, ema_feats=ema_feats,
                   pseudo_label=pseudo_label, pseudo_weight=mixed_w,
                   mix_masks=mix_masks, mixed_img=mixed_img,
                   mixed_lbl=mixed_lbl.long())
        if self.mix_feat_teacher_forward and not self.target_self_training:
            # PGSTMixFeat (``pfgst.py:303-323``): the same masks and draws
            # on the PLAIN target view, for the second teacher forward
            out['mixed_img_weak'] = transform(
                mix_masks, (img, target_img), None)[0]
        return out

    def feat_dist_loss(self, state: UDATrainState, img, gt, f_stu):
        """DACS's distance of the student's last backbone map ``f_stu`` to
        the frozen reference's (``pfgst.py:136-170``): per pixel the L2
        norm over the channels, its mean over the pixels whose label
        (sampled at the map's stride) is one of
        ``imnet_feature_dist_classes``, or over all of them, times the
        lambda. The reference runs train-mode BN, its statistics thrown
        away, and gets no gradient."""
        with torch.no_grad(), batch_stats_forward(state.imnet) as imnet, \
                imnet._autocast(img):
            f_imnet = imnet.extract_feat(img)[-1]
        diff = torch.sqrt(((f_stu.float() - f_imnet.float())**2).sum(dim=1)
                          + 1e-12)                          # (B, h, w)
        if not self.fdist_classes:
            return self.fdist_lambda * diff.mean()
        scale = gt.shape[1] // f_stu.shape[2]
        gt_small = gt[:, ::scale, ::scale]
        mask = torch.zeros_like(gt_small, dtype=torch.bool)
        for c in self.fdist_classes:
            mask = mask | (gt_small == c)
        return self.fdist_lambda * masked_mean(diff, mask)

    @torch.no_grad()
    def mix_ema_feats(self, src_feats, ema_feats, mix_masks):
        """PGST's blend (``pfgst.py:444-473``): the student's detached
        source map and the teacher's at ``mix_ema_feat_level``, both
        nearest-upsampled to the masks' full resolution and ClassMix-
        blended there; the aux losses resize it back down. As in the JAX
        file (and the reference), the other levels are dropped:
        ``[None] * lvl + [mixed]``."""
        lvl = self.mix_ema_feat_level
        ema_l = ema_feats[lvl] if isinstance(ema_feats, (tuple, list)) \
            else ema_feats
        size = tuple(mix_masks.shape[1:])
        src_up = resize(src_feats[lvl].detach(), size=size, mode='nearest')
        ema_up = resize(ema_l, size=size, mode='nearest')
        m = mix_masks[:, None]
        mixed = m * src_up + (1.0 - m) * ema_up
        return tuple(mixed if i == lvl else None for i in range(lvl + 1))

    def forward_train(self, state: UDATrainState, batch: dict, draws: dict,
                      mean, std, premix=None, collect_vis: bool = False):
        """One iteration's total loss, with the autograd graph to the
        student (``pfgst.py:326-520``). Returns ``(total, aux)``, ``aux =
        {'log_vars': ..., 'vis_states': ...}``, the latter empty unless
        ``collect_vis``. With ``premix`` given, the gradient-free half was
        computed by ``teacher_and_mix``."""
        student = state.student
        img = batch['img']
        gt = batch['gt_semantic_seg'].long()
        if premix is None:
            premix = self.teacher_and_mix(state, batch, draws, mean, std)
        mixed_img = premix['mixed_img']

        student.train()
        devices = [img.device] if img.device.type == 'cuda' else []
        with torch.random.fork_rng(devices=devices):
            torch.manual_seed(draws['dropout_seed'])
            # source pass, then the mixed pass on the running statistics
            # the source pass left (``pfgst.py:400-413``)
            clean_losses, clean_states = student.forward_train(img, gt)
            mix_losses, mix_states = student.forward_train(
                mixed_img, premix['mixed_lbl'], premix['pseudo_weight'])

        log_vars: Dict[str, torch.Tensor] = {}
        vis_states: Dict[str, tuple] = {}
        total, clean_log = parse_losses(clean_losses)
        log_vars.update(clean_log)
        if self.enable_fdist:
            # ``pfgst.py:422-427``
            fd = self.feat_dist_loss(state, img, gt,
                                     clean_states['features'][-1])
            log_vars['loss_imnet_feat_dist'] = fd
            total = total + fd
        mix_prefix = 'trg' if self.target_self_training else 'mix'
        mix_loss, mix_log = parse_losses(add_prefix(mix_losses, mix_prefix))
        log_vars.update(mix_log)
        total = total + mix_loss * self.trg_loss_weight

        ema_feats = premix['ema_feats']
        if self.mix_feat_teacher_forward:
            ema_feats = self.teacher_forward(state,
                                             premix['mixed_img_weak'])[1]
        elif self.mix_ema_feat_level is not None and \
                not self.target_self_training:
            ema_feats = self.mix_ema_feats(clean_states['features'],
                                           ema_feats, premix['mix_masks'])

        if self.aux_losses:
            key = 'decoded_features' if self.use_decoded_feats \
                else 'features'
            # FMDA's tensors carry the plain target view as img_trg
            # (``pfgst.py:476-481``), the others the student's input
            img_trg = batch['target_img'] if (
                self.target_self_training and
                self.self_training_view == 'jitter_plain') else mixed_img
            tensors = dict(
                img_src=img, img_trg=img_trg, img_mixed=mixed_img,
                gt_src=gt, x_src=clean_states[key],
                x_ema=ema_feats, x_trg=mix_states['features'],
                logits_src=clean_states['seg_logits'],
                logits_trg=mix_states['seg_logits'],
                logits_ema=premix['ema_logits'],
                mix_masks=premix['mix_masks'],
                pseudo_weight=premix['pseudo_weight'])
            aux_losses = {}
            for loss_mod in self.aux_losses:
                aux_losses.update(loss_mod(tensors) or {})
            if collect_vis:
                vis_states.update({k: v for k, v in aux_losses.items()
                                   if k.startswith('vis|')})
            aux_total, aux_log = parse_losses(aux_losses)
            log_vars.update(aux_log)
            total = total + aux_total
        if collect_vis:
            # ``pfgst.py:510-516``: the mixed labels where the pseudo-label
            # weight is positive, else the ignore index
            vis_lbl = torch.where(premix['pseudo_weight'] > 0.0,
                                  premix['mixed_lbl'], 255)
            vis_states['vis|seg_mask_src'] = (
                img, gt, clean_states['seg_logits'].detach().argmax(dim=1))
            vis_states['vis|seg_mask_mix'] = (
                mixed_img, vis_lbl,
                mix_states['seg_logits'].detach().argmax(dim=1))
        return total, dict(log_vars=log_vars, vis_states=vis_states)

    # ------------------------------------------------------------------
    def make_train_step(self, mean, std, collect_vis: bool = False,
                        group=None):
        """The train step ``(state, batch, generator, premix=None) ->
        (state, log_vars)`` (``pfgst.py:523-578``): EMA update, loss,
        backward, optimizer step, ``step + 1``, all in place on ``state``.
        With a process ``group`` it is one replica's step (``axis_name``
        of the JAX step): ``SyncBN`` spans the group, and after the whole
        backward the gradients, then the log vars, are averaged over it,
        and after the optimizer step the student's running statistics;
        ``grad_mag`` is this replica's, averaged as a log var.
        ``batch`` holds NCHW tensors on the state's device (images
        normalized, or uint8 / float16 on the 0-255 scale); ``log_vars``
        are 0-dim tensors on that device, so the step does not wait for
        the card. The gradients stay on the student's parameters until
        the next step. With ``collect_vis`` the step returns ``(state,
        log_vars, vis_states)``, the JAX step's triple. A GSPMD ``group``
        (``parallel.GlobalBatch``, the ZeRO and tensor-parallel steps) runs
        this step on the global batch, its segmentors' forwards split over
        the data ranks, and ``grad_mag`` is the whole batch's."""

        def step_fn(state: UDATrainState, batch: dict,
                    generator: torch.Generator, premix=None):
            batch = maybe_normalize_images(batch, mean, std)
            draws = self.sample_draws(generator, batch['img'].shape[0])
            self.ema_update(state, self.alpha)
            with sync_bn_group(group):
                total, aux = self.forward_train(
                    state, batch, draws, mean, std, premix=premix,
                    collect_vis=collect_vis)
            state.optimizer.zero_grad()
            total.backward()
            log_vars = {k: v.detach() for k, v in aux['log_vars'].items()}
            log_vars['loss'] = total.detach()
            # a GSPMD step reads the whole batch's gradient
            # (``parallel/global_batch.py``), a replica its own
            whole = is_global_batch(group)
            if whole:
                average_gradients(state.optimizer.params, group)
            if self.print_grad_magnitude:
                # the global L2 norm of the backbone's gradients
                # (``pfgst.py:556-562``), before the optimizer's clipping
                log_vars['grad_mag'] = gradient_norm(
                    state.student.backbone.parameters(), group)
            # ``pfgst.py:563-568``
            if not whole:
                average_gradients(state.optimizer.params, group)
            log_vars = average_log_vars(log_vars, group)
            state.optimizer.step()
            average_buffers(state.student, group)
            state.step += 1
            if collect_vis:
                return state, log_vars, aux['vis_states']
            return state, log_vars

        return step_fn
