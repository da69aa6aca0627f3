#!/usr/bin/env python
"""How well an fp32 training step of a ``configs/_base_/models`` def
reproduces the same step in fp64, on the CPU.

Each def is set up as ``chip_smoke.py`` phase 20's card-against-CPU
check sets it up (the config as it stands, dropout off, seeded weights,
each residual block's last BN scale at ``RESIDUAL_SCALE``, the heads' 0-d
``gamma``s at ``--gamma``, one batch of 2 at ``--hw``); its gradients
from one forward and backward in fp64 are the reference for those in
fp32 with all the CPU's threads and with one. It prints one ``COND``
JSON line a def and fp32 run: the gradient's cosine similarity and
relative norm gap to fp64 over all parameters and by group (stem, each
ResNet stage, each head). A gap near the check's limits (cosine 0.9999,
norm 1e-3) says the step is ill-conditioned in fp32, whatever the card
does. The port's fp32 casts (``Tensor.float``, which the losses and the
heads' products call) leave fp64 tensors in fp64 while the fp64 step
runs. For example::

    python3 tools/grad_conditioning_torch.py danet_r50-d8 --gamma 0.25

Runs on the CPU.
"""
import argparse
import contextlib
import copy
import json
import os.path as osp
import sys

import torch

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))


@contextlib.contextmanager
def _fp64_kept():
    cast = torch.Tensor.float
    torch.Tensor.float = lambda self, *a, **k: (
        self if self.dtype == torch.float64 else cast(self, *a, **k))
    try:
        yield
    finally:
        torch.Tensor.float = cast


def _grads(model, batch, dtype):
    """The gradients of one forward and backward of ``model`` in
    ``dtype``, in fp64, by group."""
    model = copy.deepcopy(model).to(dtype).train()
    with _fp64_kept() if dtype == torch.float64 else contextlib.nullcontext():
        losses, _ = model.forward_train(batch['img'].to(dtype),
                                        batch['gt_semantic_seg'])
        sum(v for k, v in losses.items() if 'loss' in k).backward()
    groups = {}
    for name, p in model.named_parameters():
        parts = name.split('.')
        key = '.'.join(parts[:2]) if parts[0] == 'backbone' else parts[0]
        groups.setdefault(key, []).append(p.grad.double().flatten())
    return {k: torch.cat(v) for k, v in groups.items()}


def _gap(a, b):
    cos = float(a @ b / (a.norm() * b.norm()))
    gap = float((a.norm() - b.norm()).abs() / b.norm())
    return [round(cos, 8), float(f'{gap:.3e}')]


def main():
    sys.path.insert(0, ROOT)
    import chip_smoke
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('defs', nargs='+',
                        help='names of configs/_base_/models defs')
    parser.add_argument('--gamma', type=float, default=chip_smoke.GAMMA_SCALE)
    parser.add_argument('--hw', type=int, default=chip_smoke.TF_CHECK_HW[0])
    args = parser.parse_args()
    threads = torch.get_num_threads()
    for name in args.defs:
        cfg = chip_smoke.model_config(
            osp.join(chip_smoke.MODEL_DEFS, f'{name}.py'), dropout=False)
        batch = chip_smoke._vit_batch(cfg, 7, (args.hw, args.hw), 'cpu')
        _, state, _ = chip_smoke._vit_train_setup(cfg, 'cpu')
        chip_smoke._scale_residual(state, chip_smoke.RESIDUAL_SCALE)
        chip_smoke._nonzero_gammas(state, args.gamma)
        ref = _grads(state.student, batch, torch.float64)
        for n in (threads, 1):
            torch.set_num_threads(n)
            got = _grads(state.student, batch, torch.float32)
            torch.set_num_threads(threads)
            print('COND ' + json.dumps(dict(
                name=name, gamma=args.gamma, hw=args.hw, threads=n,
                all=_gap(torch.cat(list(got.values())),
                         torch.cat(list(ref.values()))),
                groups={k: _gap(got[k], ref[k]) for k in ref})), flush=True)


if __name__ == '__main__':
    main()
