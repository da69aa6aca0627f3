"""Small shared helpers (copy of ``pfst_tpu/utils/misc.py``).

``add_prefix`` mirrors ``rsiseg/core/utils/misc.py:2``.  The JAX
package's ``find_latest_checkpoint`` looks for Orbax step directories,
which the port does not read yet.
"""
from __future__ import annotations


def add_prefix(inputs: dict, prefix: str) -> dict:
    """Prefix every key of ``inputs`` with ``f'{prefix}.'``."""
    return {f'{prefix}.{name}': value for name, value in inputs.items()}
