"""Small shared helpers (copy of ``pfst_tpu/utils/misc.py``).

``add_prefix`` mirrors ``rsiseg/core/utils/misc.py:2``.  The JAX
package's ``find_latest_checkpoint`` looks for Orbax step directories,
which the port does not read yet. ``resolve_device`` is the port's own:
its entry points run on the card unless asked for the CPU.
"""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('pfst_tpu_torch runs on a CUDA card by default '
                           'and none is available; pass device="cpu" to '
                           'run on the CPU')
    return device


def add_prefix(inputs: dict, prefix: str) -> dict:
    """Prefix every key of ``inputs`` with ``f'{prefix}.'``."""
    return {f'{prefix}.{name}': value for name, value in inputs.items()}
