"""Supervised training (port of ``SupervisedTrainer`` and
``build_algorithm`` in ``pfst_tpu/apis/train.py:185-258,384-389``).

``build_algorithm`` gives the UDA algorithm when the config has ``uda``,
else a ``SupervisedTrainer`` around the segmentor; both have the
orchestrator API ``init_state`` / ``make_train_step``. The JAX file's
``train_segmentor`` loop, its data pipeline, checkpoints and multi-device
step wait for the datasets.
"""
from __future__ import annotations

from typing import Union

import torch

from ..models import build_train_model
from ..models.uda.pfgst import parse_losses
from ..models.uda.uda_decorator import UDATrainState, maybe_normalize_images


class SupervisedTrainer:
    """Source-only training with the UDA algorithms' orchestrator API
    (``EncoderDecoder.train_step``, reference ``encoder_decoder.py:127-
    164``). The state's ``teacher`` is None."""

    def __init__(self, model):
        self.model = model
        self.num_classes = model.num_classes
        self.device = next(model.parameters()).device

    def get_model(self):
        return self.model

    def init_state(self, generator: torch.Generator, tx) -> UDATrainState:
        """The segmentor's weights from the JAX package's initializers,
        drawn from ``generator`` on the CPU (so every device gets the same
        model), in train mode on the trainer's device; ``tx`` is a
        ``build_optimizer`` factory, bound to its parameters."""
        student = self.model.cpu().init_weights(generator)
        student.to(self.device).train()
        return UDATrainState(student=student, teacher=None,
                             optimizer=tx(student.parameters()), step=0)

    def make_train_step(self, mean, std, collect_vis: bool = False):
        """The train step ``(state, batch, generator) -> (state,
        log_vars)`` (``train.py:216-258``): ``forward_train`` losses,
        backward, optimizer step and ``step + 1``, in place on ``state``.
        ``batch`` holds ``img`` (NCHW, normalized, or uint8 / float16 on
        the 0-255 scale) and ``gt_semantic_seg`` on the state's device.
        The dropout of the step is seeded from ``generator``, drawn on the
        CPU. ``log_vars`` are 0-dim tensors on the device."""
        if collect_vis:
            raise NotImplementedError('collect_vis is not ported')

        def step_fn(state: UDATrainState, batch: dict,
                    generator: torch.Generator):
            batch = maybe_normalize_images(batch, mean, std)
            img = batch['img']
            seed = int(torch.randint(2**62, (), generator=generator))
            devices = [img.device] if img.device.type == 'cuda' else []
            state.student.train()
            with torch.random.fork_rng(devices=devices):
                torch.manual_seed(seed)
                losses, _ = state.student.forward_train(
                    img, batch['gt_semantic_seg'])
            total, log_vars = parse_losses(losses)
            state.optimizer.zero_grad()
            total.backward()
            state.optimizer.step()
            state.step += 1
            log_vars = {k: v.detach() for k, v in log_vars.items()}
            log_vars['loss'] = total.detach()
            return state, log_vars

        return step_fn


def build_algorithm(cfg, device: Union[str, torch.device] = 'cuda'):
    """UDA wrapper or supervised trainer, both orchestrator-shaped, on
    ``device`` (the card unless the CPU is asked for)."""
    model_or_algo = build_train_model(cfg, device=device)
    if hasattr(model_or_algo, 'make_train_step'):
        return model_or_algo
    return SupervisedTrainer(model_or_algo)
