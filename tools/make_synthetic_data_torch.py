#!/usr/bin/env python
"""Write a synthetic dataset with numpy and zlib alone (the PyTorch
port's counterpart of ``tools/make_synthetic_data.py``), in one of three
layouts (``--layout``):

* ``isprs`` (the default): ``{out}/img_dir/{train,val}/t{i}.png`` and
  ``ann_dir/...``, blobby label maps of classes 0..num_classes (0 is the
  boundary class under ``reduce_zero_label``);
* ``inria``: the Inria feeder's layout,
  ``{out}/Inria_clipped/{train,val}/{images,gt}/{city}{i}.png``, RGB tiles
  with labels 0 (background) and 1 (building): ``--num-train`` tiles of
  each of the five cities of the Inria config (austin, chicago, kitsap ->
  vienna, tyrol-w) under ``train``, ``--num-val`` of each target city
  under ``val``;
* ``season_net``: the SeasonNet feeder's layout,
  ``{out}/{train,val,test}/{images,labels}/{season}_{i}.tif``, 16-bit RGB
  tiles on the raw scale of the config's ClipNormalize (up to 4080) and
  8-bit labels of classes 1..33 (0 is ignored under
  ``reduce_zero_label``), both LZW with the horizontal predictor as
  ``cv2.imwrite`` stores them: ``--num-train`` spring and fall tiles under
  ``train``, ``--num-val`` fall tiles under ``val`` and ``test``.

Images are tinted by class plus noise, so that the labels are learnable
from the images. The layout is the JAX tool's; the
bytes are not: the port upsamples with torch's bicubic, not cv2's, and
tints class k (1..num_classes) with the fully saturated hue k/num_classes
of the colour wheel (class 0 black), where the JAX tool scales one colour
by the class. The leaf config's photometric distortion shifts brightness
by up to 32 and scales contrast by 0.5-1.5 per image, more than the JAX
tool's step of 29 levels between classes, but keeps hues within 36
degrees, less than the 60 between six classes here::

    python tools/make_synthetic_data_torch.py -o data/Potsdam_IRRG_1024 \\
        --num-train 8 --num-val 0
    python tools/make_synthetic_data_torch.py -o data/Inria --layout inria \\
        --num-train 3 --num-val 1
    python tools/make_synthetic_data_torch.py -o data/SeasonNet \\
        --layout season_net --size 120 --num-train 64 --num-val 16
"""
import argparse
import os
import os.path as osp
import sys

sys.path.insert(0, osp.join(osp.dirname(osp.abspath(__file__)), '..'))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from pfst_tpu_torch.datasets.pipelines.png import write_png  # noqa: E402
from pfst_tpu_torch.datasets.pipelines.tiff import write_tiff  # noqa: E402
from pfst_tpu_torch.native import hostaug  # noqa: E402


INRIA_CITIES = {'train': ('austin', 'chicago', 'kitsap', 'vienna', 'tyrol-w'),
                'val': ('vienna', 'tyrol-w')}
# SeasonNet: 16-bit values are the 8-bit design times 16 (up to 4080, the
# raw range around the config's ClipNormalize mean of ~818)
SEASON_NET_SCALE = 16


def blobby_labels(rs, size, num_classes):
    """Low-frequency noise, upsampled bicubically, argmax: contiguous
    class regions."""
    small = rs.rand(1, num_classes + 1, max(size // 32, 2),
                    max(size // 32, 2))
    up = F.interpolate(torch.from_numpy(small), size=(size, size),
                       mode='bicubic', align_corners=False)
    return up[0].argmax(0).numpy().astype(np.uint8)


def class_tints(num_classes):
    """BGR tint of each label value: black for 0, then evenly spaced,
    fully saturated hues."""
    hsv = np.zeros((1, num_classes + 1, 3), np.uint8)
    hsv[0, 1:, 0] = np.arange(num_classes) * 180 // num_classes
    hsv[0, 1:, 1:] = 255
    return hostaug.hsv2bgr(hsv)[0].astype(np.float64)


def parse_args(args=None):
    p = argparse.ArgumentParser(description='Write a synthetic dataset')
    p.add_argument('-o', '--out', required=True)
    p.add_argument('--layout', default='isprs',
                   choices=('isprs', 'inria', 'season_net'))
    p.add_argument('--size', type=int, default=1024)
    p.add_argument('--num-train', type=int, default=8)
    p.add_argument('--num-val', type=int, default=2)
    p.add_argument('--num-classes', type=int, default=None,
                   help='isprs: 6 (the default); inria: 2 and season_net: '
                   '33, fixed')
    p.add_argument('--seed', type=int, default=0)
    return p.parse_args(args)


def tile(rs, size, palette, labels):
    """An (H, W, 3) image of class tints plus noise, on the 0-255 scale
    (float), for a label map of palette indices."""
    noise = rs.randint(0, 255, (size, size, 3))
    return np.clip(0.5 * noise + 0.5 * palette[labels.astype(np.int64)], 0,
                   255)


def main(args=None):
    a = parse_args(args)
    rs = np.random.RandomState(a.seed)
    fixed = {'inria': 2, 'season_net': 33}.get(a.layout)
    if fixed is not None and a.num_classes not in (None, fixed):
        raise ValueError(f'the {a.layout} layout has {fixed} classes')
    if a.layout == 'isprs':
        num_classes = a.num_classes or 6
        palette = class_tints(num_classes)
        for split, n in (('train', a.num_train), ('val', a.num_val)):
            os.makedirs(osp.join(a.out, 'img_dir', split), exist_ok=True)
            os.makedirs(osp.join(a.out, 'ann_dir', split), exist_ok=True)
            for i in range(n):
                ann = blobby_labels(rs, a.size, num_classes)
                img = tile(rs, a.size, palette, ann).astype(np.uint8)
                write_png(osp.join(a.out, 'img_dir', split, f't{i}.png'),
                          img)
                write_png(osp.join(a.out, 'ann_dir', split, f't{i}.png'),
                          ann)
    elif a.layout == 'inria':
        palette = class_tints(1)
        for split, n in (('train', a.num_train), ('val', a.num_val)):
            base = osp.join(a.out, 'Inria_clipped', split)
            for d in ('images', 'gt'):
                os.makedirs(osp.join(base, d), exist_ok=True)
            for city in INRIA_CITIES[split]:
                for i in range(n):
                    gt = blobby_labels(rs, a.size, 1)
                    img = tile(rs, a.size, palette, gt).astype(np.uint8)
                    name = f'{city}{i + 1}.png'
                    write_png(osp.join(base, 'images', name), img)
                    write_png(osp.join(base, 'gt', name), gt)
    else:
        palette = class_tints(33)
        for split, seasons, n in (('train', ('spring', 'fall'), a.num_train),
                                  ('val', ('fall',), a.num_val),
                                  ('test', ('fall',), a.num_val)):
            for d in ('images', 'labels'):
                os.makedirs(osp.join(a.out, split, d), exist_ok=True)
            for season in seasons:
                for i in range(n):
                    label = blobby_labels(rs, a.size, 33)
                    img = tile(rs, a.size, palette, label) * SEASON_NET_SCALE
                    name = f'{season}_{i}.tif'
                    write_tiff(osp.join(a.out, split, 'images', name),
                               img.astype(np.uint16))
                    write_tiff(osp.join(a.out, split, 'labels', name), label)
    print(f'synthetic {a.layout} dataset at {a.out}')


if __name__ == '__main__':
    main()
