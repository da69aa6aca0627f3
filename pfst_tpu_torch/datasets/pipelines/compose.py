"""Pipeline composition (port of
``pfst_tpu/datasets/pipelines/compose.py``)."""
from __future__ import annotations

from ..builder import PIPELINES


class Compose:

    def __init__(self, transforms):
        self.transforms = []
        for t in transforms:
            if callable(t):
                self.transforms.append(t)
            else:
                self.transforms.append(PIPELINES.build(dict(t)))

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
            if data is None:
                return None
        return data

    def __repr__(self):
        return 'Compose(\n' + '\n'.join(
            f'    {t!r}' for t in self.transforms) + '\n)'
