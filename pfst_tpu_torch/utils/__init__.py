from .config import Config, ConfigDict, DictAction, merge_dict
from .logger import get_root_logger, print_log
from .misc import add_prefix, resolve_device
from .registry import Registry

__all__ = [
    'Config', 'ConfigDict', 'DictAction', 'merge_dict', 'get_root_logger',
    'print_log', 'add_prefix', 'resolve_device', 'Registry'
]
