"""Checkpoints of the train state (port of ``pfst_tpu/core/checkpoint.py``).

The JAX package writes Orbax step directories; the port writes one
``torch.save`` file per save in mmcv's layout (``{work_dir}/iter_<N>.pth``,
reference ``tools/train.py:228-235``, ``apis/train.py:184-191``)::

    {'meta': {..., 'iter': N},
     'state_dict': {'model.<key>': student, 'ema_model.<key>': teacher,
                    'imnet_model.<key>': frozen reference (DACS's feature
                                         distance on),
                    'discriminator.<key>': DomainAdaptorAdv's},
     'optimizer': <torch.optim state_dict>,
     'scheduler': <LR scheduler state_dict or None>,
     'optimizer_extra': <cumulative_iters' accumulator, skip_nonfinite's
                         counters>,
     'disc_optimizer': {'optimizer', 'scheduler', 'optimizer_extra'}
                       (DomainAdaptorAdv's)}

A supervised run, and a domain adaptor without a discriminator, has no
teacher, and its student keys carry no prefix.
``tools/convert_torch_checkpoint.py`` reads the student of either into the
JAX package; ``tools/convert_jax_checkpoint_torch.py`` carries an Orbax
checkpoint the other way (Orbax needs JAX, which the port does not
import).
"""
from __future__ import annotations

import glob
import os
import os.path as osp
import re
from typing import Dict, Optional

import torch

from ..utils.logger import print_log


def checkpoint_path(work_dir: str, step: int) -> str:
    return osp.join(work_dir, f'iter_{int(step)}.pth')


def _prefixed(state):
    """(module, key prefix) of each module of a train state with more than
    the student: the student, the teacher, the feature distance's frozen
    reference (rsiseg's DACS ``imnet_model``) and the adversarial adaptor's
    discriminator, where there are."""
    out = [(state.student, 'model.')]
    for attr, prefix in (('teacher', 'ema_model.'), ('imnet', 'imnet_model.'),
                         ('discriminator', 'discriminator.')):
        if getattr(state, attr, None) is not None:
            out.append((getattr(state, attr), prefix))
    return out


def _student_only(state) -> bool:
    return len(_prefixed(state)) == 1


def state_dict_of(state) -> Dict[str, torch.Tensor]:
    """The rsiseg-layout state dict of a train state: ``model.`` +
    student, ``ema_model.`` + teacher (and ``imnet_model.`` + the frozen
    reference, ``discriminator.`` + the discriminator), bare keys for a
    student alone."""
    if _student_only(state):
        return dict(state.student.state_dict())
    return {f'{prefix}{k}': v for module, prefix in _prefixed(state)
            for k, v in module.state_dict().items()}


def save_checkpoint(work_dir: str, step: int, state,
                    meta: Optional[Dict] = None) -> str:
    """Write the whole train state (student, teacher, optimizer moments,
    LR schedule position and step) to ``{work_dir}/iter_<step>.pth``; the
    file appears whole or not at all."""
    os.makedirs(work_dir, exist_ok=True)
    obj = {'meta': {**(meta or {}), 'iter': int(step)},
           'state_dict': state_dict_of(state), **_optimizer_entry(
               state.optimizer)}
    if getattr(state, 'disc_optimizer', None) is not None:
        obj['disc_optimizer'] = _optimizer_entry(state.disc_optimizer)
    path = checkpoint_path(work_dir, step)
    tmp = f'{path}.tmp{os.getpid()}'
    try:
        torch.save(obj, tmp)
        os.replace(tmp, path)
    finally:
        if osp.exists(tmp):
            os.remove(tmp)
    return path


def _optimizer_entry(opt) -> Dict:
    return {'optimizer': opt.optimizer.state_dict(),
            'scheduler': opt.scheduler.state_dict()
            if opt.scheduler is not None else None,
            'optimizer_extra': opt.extra_state()}


def _restore_optimizer(opt, entry: Dict):
    opt.optimizer.load_state_dict(entry['optimizer'])
    if opt.scheduler is not None:
        if entry.get('scheduler') is None:
            raise ValueError('the checkpoint has no LR schedule state')
        opt.scheduler.load_state_dict(entry['scheduler'])
    opt.load_extra_state(entry.get('optimizer_extra'))


def load_checkpoint(path: str) -> Dict:
    """The saved dictionary, tensors on the CPU."""
    return torch.load(osp.expanduser(path), map_location='cpu',
                      weights_only=True)


def extract_student(ckpt: Dict) -> Dict[str, torch.Tensor]:
    """The student's weights: the ``state_dict`` entry if there is one,
    ``module.`` stripped and, for UDA checkpoints, ``model.`` stripped and
    ``ema_model.`` dropped (rsiseg ``tools/test.py:237-242``)."""
    sd = ckpt.get('state_dict', ckpt)
    sd = {k[len('module.'):] if k.startswith('module.') else k: v
          for k, v in sd.items()}
    if any(k.startswith('model.') for k in sd):
        sd = {k[len('model.'):]: v for k, v in sd.items()
              if k.startswith('model.')}
    return sd


def restore_state(state, ckpt: Dict):
    """Resume: load student, teacher (frozen reference, discriminator),
    the optimizers with their LR schedules, accumulators and counters, and
    the step of ``ckpt`` into ``state`` exactly (``resume_from``)."""
    sd = ckpt['state_dict']
    if _student_only(state):
        state.student.load_state_dict(sd)
    else:
        for module, prefix in _prefixed(state):
            module.load_state_dict({k[len(prefix):]: v
                                    for k, v in sd.items()
                                    if k.startswith(prefix)})
    _restore_optimizer(state.optimizer, ckpt)
    if getattr(state, 'disc_optimizer', None) is not None:
        _restore_optimizer(state.disc_optimizer, ckpt['disc_optimizer'])
    state.step = int(ckpt['meta']['iter'])
    return state


@torch.no_grad()
def load_weights_into_state(state, ckpt: Dict, logger=None):
    """Warm start (``load_from``): the student's weights from ``ckpt``
    where names and shapes match (the rest keep their init, with a
    warning, as mmcv's ``strict=False``), the teacher and the feature
    distance's frozen reference copies of the loaded student, as the JAX
    loop refreshes them (``apis/train.py:285-316``); a discriminator, the
    optimizers and the step stay fresh."""
    own = state.student.state_dict()
    loaded = extract_student(ckpt)
    for key, value in loaded.items():
        if key not in own:
            print_log(f'load_from: unexpected key {key} (skipped)', logger)
        elif own[key].shape != value.shape:
            print_log(f'load_from: shape mismatch at {key} '
                      f'{tuple(value.shape)} vs {tuple(own[key].shape)} '
                      f'(skipped)', logger)
        else:
            own[key].copy_(value)
    for key in own.keys() - loaded.keys():
        print_log(f'load_from: missing key {key} (init kept)', logger)
    for module in (state.teacher, getattr(state, 'imnet', None)):
        if module is not None:
            module.load_state_dict(state.student.state_dict())
    return state


def find_latest_checkpoint(work_dir: Optional[str]) -> Optional[str]:
    """The highest-iteration ``iter_<N>.pth`` in ``work_dir``, or None."""
    if not work_dir or not osp.isdir(work_dir):
        return None
    best = None
    for path in glob.glob(osp.join(work_dir, 'iter_*.pth')):
        m = re.fullmatch(r'iter_(\d+)\.pth', osp.basename(path))
        if m and (best is None or int(m.group(1)) > best[0]):
            best = (int(m.group(1)), path)
    return best[1] if best else None
