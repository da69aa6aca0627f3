#!/usr/bin/env python
"""Print the fully merged config (the PyTorch port's counterpart of
``tools/print_config.py``)::

    python tools/print_config_torch.py <config> [--cfg-options k=v ...]
"""
import argparse
import os.path as osp
import sys

sys.path.insert(0, osp.join(osp.dirname(osp.abspath(__file__)), '..'))

from pfst_tpu_torch.utils import Config, DictAction  # noqa: E402


def main(args=None):
    p = argparse.ArgumentParser(description='Print a merged config')
    p.add_argument('config')
    p.add_argument('--cfg-options', nargs='+', action=DictAction)
    a = p.parse_args(args)
    cfg = Config.fromfile(a.config)
    if a.cfg_options:
        cfg.merge_from_dict(a.cfg_options)
    text = cfg.dump()
    print(text)
    return text


if __name__ == '__main__':
    main()
