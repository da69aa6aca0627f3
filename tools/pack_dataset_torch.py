#!/usr/bin/env python
"""Pack image directories into mmap blobs for decode-free loading, with
the PyTorch port's own PNG and TIFF readers (the port's counterpart of
``tools/pack_dataset.py``; both write the same format, and the packs of
either are read by both packages)::

    python tools/pack_dataset_torch.py data/Potsdam_IRRG_1024 --recursive
    python tools/pack_dataset_torch.py data/X/img_dir/train data/X/ann_dir/train

Each directory gets ``.pfst_pack.bin.*`` (the pixels) and
``.pfst_pack.json`` (name -> offset/shape/dtype). Re-run after changing a
directory; images not in the pack are decoded from disk.
"""
import argparse
import os
import os.path as osp
import sys

sys.path.insert(0, osp.join(osp.dirname(osp.abspath(__file__)), '..'))


def parse_args(args=None):
    p = argparse.ArgumentParser(description='Pack image dirs into mmap '
                                'blobs')
    p.add_argument('dirs', nargs='+', help='directories of images')
    p.add_argument('-r', '--recursive', action='store_true',
                   help='descend into subdirectories')
    return p.parse_args(args)


def main(args=None):
    args = parse_args(args)
    from pfst_tpu_torch.datasets.pipelines.packing import (IMAGE_EXTS,
                                                           pack_directory)
    targets = []
    for d in args.dirs:
        if args.recursive:
            for root, _, files in os.walk(d):
                if any(f.lower().endswith(IMAGE_EXTS) for f in files):
                    targets.append(root)
        else:
            targets.append(d)
    total = 0
    for d in sorted(set(targets)):
        n = pack_directory(d)
        total += n
        print(f'{d}: packed {n} images')
    print(f'total: {total} images')
    return total


if __name__ == '__main__':
    main()
