"""Lightweight registry for pluggable components.

Copy of ``pfst_tpu/utils/registry.py``: a replacement for the mmcv
``Registry`` (``rsiseg/models/builder.py:8-17``).  Unlike mmcv there is no
parent/child scoping: a single flat namespace per registry, with
``build(cfg)`` dispatching on ``cfg['type']``.
"""
from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, Optional


class Registry:
    """A string -> class/function map with a ``build`` helper."""

    def __init__(self, name: str):
        self._name = name
        self._module_dict: Dict[str, Any] = {}

    def __len__(self):
        return len(self._module_dict)

    def __contains__(self, key):
        return key in self._module_dict

    def __repr__(self):
        return (f'Registry(name={self._name}, '
                f'items={list(self._module_dict)})')

    @property
    def name(self):
        return self._name

    @property
    def module_dict(self):
        return self._module_dict

    def get(self, key: str) -> Optional[Any]:
        return self._module_dict.get(key)

    def register_module(self,
                        name: Optional[str] = None,
                        force: bool = False,
                        module: Optional[Any] = None) -> Callable:
        """Register a class or function, usable as a decorator."""
        if module is not None:
            self._register(module, name, force)
            return module

        def _decorator(cls):
            self._register(cls, name, force)
            return cls

        return _decorator

    def _register(self, module, name, force):
        if not (inspect.isclass(module) or inspect.isfunction(module)):
            raise TypeError(f'module must be a class or function, '
                            f'got {type(module)}')
        key = name if name is not None else module.__name__
        if not force and key in self._module_dict:
            raise KeyError(f'{key} is already registered in {self._name}')
        self._module_dict[key] = module

    def build(self, cfg: dict, **default_kwargs) -> Any:
        """Instantiate ``cfg['type']`` with the remaining keys as kwargs."""
        if cfg is None:
            return None
        from collections.abc import Mapping
        if not isinstance(cfg, Mapping):
            raise TypeError(f'cfg must be a dict, got {type(cfg)}')
        args = dict(cfg)
        obj_type = args.pop('type', None)
        if obj_type is None:
            raise KeyError(f'cfg for registry {self._name} has no "type": '
                           f'{cfg}')
        if isinstance(obj_type, str):
            obj_cls = self.get(obj_type)
            if obj_cls is None:
                raise KeyError(
                    f'{obj_type} is not registered in {self._name}. '
                    f'Available: {sorted(self._module_dict)}')
        else:
            obj_cls = obj_type
        for k, v in default_kwargs.items():
            args.setdefault(k, v)
        return obj_cls(**args)
