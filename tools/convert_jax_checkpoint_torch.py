#!/usr/bin/env python
"""Carry an Orbax checkpoint of the JAX package into a checkpoint of the
PyTorch port::

    python tools/convert_jax_checkpoint_torch.py <config> \\
        work_dirs/run/ckpt/4000 work_dirs/run_torch/iter_4000.pth

Imports both packages (Orbax needs JAX, which the port does not import).
The student (``params``, ``batch_stats``) and, for UDA, the teacher
(``ema_params``, ``ema_batch_stats``) go through
``pfst_tpu_torch/core/convert.py::jax_variables_to_state_dict``; the step
carries over with the LR schedule resumed there. The optimizer's moments
do not: the written checkpoint resumes (``--resume-from``) with fresh
moments, or warm-starts (``--load-from``).
"""
import argparse
import os.path as osp
import sys
from types import SimpleNamespace

sys.path.insert(0, osp.join(osp.dirname(osp.abspath(__file__)), '..'))


def parse_args(args=None):
    p = argparse.ArgumentParser(description='Orbax checkpoint -> port '
                                'checkpoint')
    p.add_argument('config')
    p.add_argument('checkpoint', help='Orbax step directory')
    p.add_argument('out', help='output .pth file')
    return p.parse_args(args)


def convert(cfg, restored):
    """A port train state (on the CPU) holding the JAX tree ``restored``
    (the dict Orbax restores a train state as)."""
    import torch

    from pfst_tpu_torch.apis import build_algorithm
    from pfst_tpu_torch.core import build_optimizer, load_jax_train_state
    algo = build_algorithm(cfg, device='cpu')
    opt_cfg = cfg.get('optimizer_config') or {}
    tx = build_optimizer(cfg.optimizer, cfg.get('lr_config'),
                         cfg.runner['max_iters'], opt_cfg.get('grad_clip'))
    state = algo.init_state(torch.Generator().manual_seed(0), tx)
    jstate = SimpleNamespace(
        params=restored['params'],
        batch_stats=restored.get('batch_stats') or {},
        ema_params=restored.get('ema_params') or {},
        ema_batch_stats=restored.get('ema_batch_stats') or {},
        step=restored.get('step', 0))
    if state.teacher is None:
        from pfst_tpu_torch.core import jax_variables_to_state_dict
        from pfst_tpu_torch.core.convert import backbone_family
        ref = state.student.state_dict()
        state.student.load_state_dict(jax_variables_to_state_dict(
            {'params': jstate.params, 'batch_stats': jstate.batch_stats},
            ref, backbone_family(state.student)))
        state.step = int(jstate.step)
        state.optimizer.set_step(state.step)
        return state
    return load_jax_train_state(jstate, state)


def main(args=None):
    args = parse_args(args)
    from pfst_tpu.core.checkpoint import load_checkpoint as load_orbax
    from pfst_tpu_torch.core.checkpoint import save_checkpoint
    from pfst_tpu_torch.utils import Config
    cfg = Config.fromfile(args.config)
    state = convert(cfg, load_orbax(args.checkpoint))
    out_dir, name = osp.split(osp.abspath(args.out))
    path = save_checkpoint(out_dir, state.step, state,
                           meta=dict(converted_from=args.checkpoint))
    if osp.basename(path) != name:
        import os
        os.replace(path, osp.join(out_dir, name))
    print(f'wrote {args.out} (step {state.step})')
    return osp.join(out_dir, name)


if __name__ == '__main__':
    main()
