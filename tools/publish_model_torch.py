#!/usr/bin/env python
"""Publish a trained checkpoint (the PyTorch port's counterpart of
``tools/publish_model.py``)::

    python tools/publish_model_torch.py <iter_N.pth> <out_dir>

Keeps the student's weights (teacher, optimizer and schedule dropped),
stamps them with the first 8 hex digits of a sha256 over the student's
state dict (each tensor's bytes in key order) and writes
``<out_dir>/iter_0.pth`` with ``meta['sha256']``, loadable by
``tools/test_torch.py`` and ``init_segmentor``.
"""
import argparse
import hashlib
import os
import os.path as osp
import sys

sys.path.insert(0, osp.join(osp.dirname(osp.abspath(__file__)), '..'))


def digest(state_dict) -> str:
    """The sha256 stamp of a state dict, 8 hex digits."""
    h = hashlib.sha256()
    for v in state_dict.values():
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:8]


def main(args=None):
    p = argparse.ArgumentParser(description='Publish a checkpoint')
    p.add_argument('in_ckpt', help='a checkpoint of the port (.pth)')
    p.add_argument('out_dir', help='output dir for the published ckpt')
    a = p.parse_args(args)

    import torch

    from pfst_tpu_torch.core.checkpoint import (checkpoint_path,
                                                extract_student,
                                                load_checkpoint)
    student = extract_student(load_checkpoint(a.in_ckpt))
    stamp = digest(student)
    os.makedirs(a.out_dir, exist_ok=True)
    path = checkpoint_path(a.out_dir, 0)
    torch.save({'meta': {'sha256': stamp, 'iter': 0},
                'state_dict': student}, path)
    print(f'published {path} (sha256 {stamp})')
    return path, stamp


if __name__ == '__main__':
    main()
