"""Python-file config system with ``_base_`` inheritance.

Copy of ``pfst_tpu/utils/config.py`` (the port imports nothing of the
JAX package): the public config surface of mmcv (``Config.fromfile`` +
``--cfg-options`` overrides) as a small standalone module: a config is
a plain ``.py`` file whose module-level variables form a dict;
``_base_`` lists parent configs that are deep-merged (child wins;
``_delete_=True`` in a child dict replaces instead of merges).
"""
from __future__ import annotations

import ast
import copy
import os
import os.path as osp
import sys
import tempfile
import types
from typing import Any, Dict, List, Optional, Union

BASE_KEY = '_base_'
DELETE_KEY = '_delete_'
RESERVED_KEYS = ('filename', 'text')


class ConfigDict(dict):
    """dict with attribute access, recursively applied."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(
                f"'ConfigDict' object has no attribute '{name}'")

    def __setattr__(self, name, value):
        self[name] = wrap_config(value)

    def __setitem__(self, name, value):
        super().__setitem__(name, wrap_config(value))

    def __deepcopy__(self, memo):
        other = ConfigDict()
        memo[id(self)] = other
        for key, value in self.items():
            dict.__setitem__(other, copy.deepcopy(key, memo),
                             copy.deepcopy(value, memo))
        return other

    def get(self, name, default=None):
        return super().get(name, default)

    def copy(self):
        return copy.deepcopy(self)

    def to_dict(self):
        return unwrap_config(self)


def wrap_config(obj):
    if isinstance(obj, ConfigDict):
        return obj
    if isinstance(obj, dict):
        return ConfigDict({k: wrap_config(v) for k, v in obj.items()})
    if isinstance(obj, list):
        return [wrap_config(v) for v in obj]
    if isinstance(obj, tuple):
        return tuple(wrap_config(v) for v in obj)
    return obj


def unwrap_config(obj):
    if isinstance(obj, dict):
        return {k: unwrap_config(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [unwrap_config(v) for v in obj]
    if isinstance(obj, tuple):
        return tuple(unwrap_config(v) for v in obj)
    return obj


def _exec_py_config(filename: str) -> Dict[str, Any]:
    """Execute a python config file and return its module-level dict."""
    filename = osp.abspath(osp.expanduser(filename))
    if not osp.isfile(filename):
        raise FileNotFoundError(f'config file not found: {filename}')
    with open(filename, encoding='utf-8') as f:
        content = f.read()
    try:
        ast.parse(content)
    except SyntaxError as e:
        raise SyntaxError(f'invalid syntax in config {filename}: {e}')
    mod = types.ModuleType('_pfst_cfg_')
    mod.__file__ = filename
    exec(compile(content, filename, 'exec'), mod.__dict__)
    cfg = {
        k: v
        for k, v in mod.__dict__.items()
        if not k.startswith('__') and not isinstance(v, types.ModuleType)
        and not isinstance(v, types.FunctionType)
    }
    return cfg


def merge_dict(base: dict, child: dict, allow_list_keys: bool = False):
    """Deep-merge ``child`` into ``base`` (child values win).

    A child dict carrying ``_delete_=True`` replaces the base value
    wholesale rather than merging, matching mmcv semantics.
    """
    base = copy.deepcopy(base)
    for key, value in child.items():
        if allow_list_keys and key.isdigit() and isinstance(base, list):
            idx = int(key)
            if idx >= len(base):
                raise KeyError(f'index {idx} out of range for list of '
                               f'length {len(base)}')
            base[idx] = merge_dict(base[idx], value, allow_list_keys) \
                if isinstance(value, dict) else value
            continue
        if (isinstance(value, dict) and key in base
                and not value.pop(DELETE_KEY, False)):
            if (isinstance(base[key], list) and allow_list_keys
                    and value and all(
                        isinstance(k, str) and k.isdigit()
                        for k in value)):
                # dotted numeric overrides into a list
                # (``--cfg-options data.train.pipeline.0.x=y``):
                # recurse so the digit-key branch above indexes the
                # list instead of clobbering it with {'0': ...}
                base[key] = merge_dict(base[key], value,
                                       allow_list_keys)
            elif not isinstance(base[key], dict):
                base[key] = value
            else:
                base[key] = merge_dict(base[key], value, allow_list_keys)
        else:
            if isinstance(value, dict):
                value = {k: v for k, v in value.items() if k != DELETE_KEY}
            base[key] = value
    return base


class Config:
    """Composable config object (mirror of the reference's config API)."""

    def __init__(self,
                 cfg_dict: Optional[dict] = None,
                 filename: Optional[str] = None,
                 text: str = ''):
        cfg_dict = cfg_dict or {}
        for key in cfg_dict:
            if key in RESERVED_KEYS:
                raise KeyError(f'{key} is reserved')
        object.__setattr__(self, '_cfg_dict', wrap_config(cfg_dict))
        object.__setattr__(self, '_filename', filename)
        object.__setattr__(self, '_text', text)

    @staticmethod
    def fromfile(filename: str) -> 'Config':
        cfg_dict, text = Config._load_with_base(filename)
        return Config(cfg_dict, filename=filename, text=text)

    @staticmethod
    def _load_with_base(filename: str):
        filename = osp.abspath(osp.expanduser(filename))
        cfg_dict = _exec_py_config(filename)
        with open(filename, encoding='utf-8') as f:
            text = f.read()
        base_files = cfg_dict.pop(BASE_KEY, None)
        if base_files is None:
            return cfg_dict, text
        if isinstance(base_files, str):
            base_files = [base_files]
        cfg_dir = osp.dirname(filename)
        merged: Dict[str, Any] = {}
        texts: List[str] = []
        for base in base_files:
            base_dict, base_text = Config._load_with_base(
                osp.join(cfg_dir, base))
            dup = set(merged) & set(base_dict)
            if dup:
                raise KeyError(f'duplicate keys across _base_ files: {dup}')
            merged.update(base_dict)
            texts.append(base_text)
        merged = merge_dict(merged, cfg_dict)
        texts.append(text)
        return merged, '\n'.join(texts)

    @staticmethod
    def fromstring(cfg_str: str) -> 'Config':
        with tempfile.NamedTemporaryFile(
                'w', suffix='.py', delete=False) as f:
            f.write(cfg_str)
            fname = f.name
        try:
            cfg = Config.fromfile(fname)
        finally:
            os.remove(fname)
        return cfg

    # ---- dict-like interface -------------------------------------------
    @property
    def filename(self):
        return self._filename

    @property
    def text(self):
        return self._text

    def __getattr__(self, name):
        return getattr(self._cfg_dict, name)

    def __getitem__(self, name):
        return self._cfg_dict[name]

    def __setattr__(self, name, value):
        self._cfg_dict[name] = value

    def __setitem__(self, name, value):
        self._cfg_dict[name] = value

    def __contains__(self, name):
        return name in self._cfg_dict

    def __iter__(self):
        return iter(self._cfg_dict)

    def __len__(self):
        return len(self._cfg_dict)

    def __repr__(self):
        return f'Config (path: {self._filename}): {self._cfg_dict}'

    def get(self, name, default=None):
        return self._cfg_dict.get(name, default)

    def keys(self):
        return self._cfg_dict.keys()

    def items(self):
        return self._cfg_dict.items()

    def values(self):
        return self._cfg_dict.values()

    def copy(self):
        return Config(copy.deepcopy(unwrap_config(self._cfg_dict)),
                      filename=self._filename, text=self._text)

    def to_dict(self):
        return unwrap_config(self._cfg_dict)

    def dump(self, file: Optional[str] = None):
        """Dump the merged config as pretty-printed python."""
        import pprint
        s = ''
        for k, v in self._cfg_dict.items():
            s += f'{k} = {pprint.pformat(unwrap_config(v), width=100)}\n'
        if file is None:
            return s
        with open(file, 'w', encoding='utf-8') as f:
            f.write(s)
        return s

    def merge_from_dict(self, options: Dict[str, Any],
                        allow_list_keys: bool = True):
        """Merge dotted-key overrides (the ``--cfg-options`` CLI path)."""
        option_cfg: Dict[str, Any] = {}
        for full_key, v in options.items():
            d = option_cfg
            parts = full_key.split('.')
            for sub in parts[:-1]:
                d = d.setdefault(sub, {})
            d[parts[-1]] = v
        merged = merge_dict(
            unwrap_config(self._cfg_dict), option_cfg,
            allow_list_keys=allow_list_keys)
        object.__setattr__(self, '_cfg_dict', wrap_config(merged))


class DictAction:
    """argparse action parsing KEY=VALUE pairs with literal-eval values.

    Usage: ``parser.add_argument('--cfg-options', nargs='+',
    action=DictAction)`` — mirrors ``tools/train.py:73-88`` in the
    reference.
    """

    def __init__(self, option_strings, dest, nargs=None, **kwargs):
        self.option_strings = option_strings
        self.dest = dest
        self.nargs = nargs
        self.required = kwargs.get('required', False)
        self.default = kwargs.get('default', None)
        self.const = None
        self.choices = None
        self.help = kwargs.get('help', None)
        self.metavar = kwargs.get('metavar', None)
        self.type = None

    @staticmethod
    def _parse_value(val: str):
        try:
            return ast.literal_eval(val)
        except (ValueError, SyntaxError):
            pass
        if val.lower() in ('true', 'false'):
            return val.lower() == 'true'
        if val.lower() in ('none', 'null'):
            return None
        if ',' in val or (val.startswith('(') and val.endswith(')')):
            inner = val.strip('()')
            if inner:
                return tuple(
                    DictAction._parse_value(v) for v in inner.split(','))
        return val

    def __call__(self, parser, namespace, values, option_string=None):
        options = getattr(namespace, self.dest, None) or {}
        for kv in values:
            key, val = kv.split('=', maxsplit=1)
            options[key] = self._parse_value(val)
        setattr(namespace, self.dest, options)
