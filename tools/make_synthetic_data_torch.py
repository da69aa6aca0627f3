#!/usr/bin/env python
"""Write a synthetic ISPRS-layout dataset with numpy and zlib alone (the
PyTorch port's counterpart of ``tools/make_synthetic_data.py``).

Creates ``{out}/img_dir/{train,val}/t{i}.png`` and ``ann_dir/...`` with
blobby label maps (classes 0..num_classes; 0 is the boundary class under
``reduce_zero_label``) and images tinted by class plus noise, so that the
labels are learnable from the images. The layout is the JAX tool's; the
bytes are not: the port upsamples with torch's bicubic, not cv2's, and
tints class k (1..num_classes) with the fully saturated hue k/num_classes
of the colour wheel (class 0 black), where the JAX tool scales one colour
by the class. The leaf config's photometric distortion shifts brightness
by up to 32 and scales contrast by 0.5-1.5 per image, more than the JAX
tool's step of 29 levels between classes, but keeps hues within 36
degrees, less than the 60 between six classes here::

    python tools/make_synthetic_data_torch.py -o data/Potsdam_IRRG_1024 \\
        --num-train 8 --num-val 0
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
from pfst_tpu_torch.native import hostaug  # noqa: E402


def blobby_labels(rs, size, num_classes):
    """Low-frequency noise, upsampled bicubically, argmax: contiguous
    class regions."""
    small = rs.rand(1, num_classes + 1, size // 32, size // 32)
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
    p = argparse.ArgumentParser(description='Write a synthetic ISPRS-layout '
                                'dataset')
    p.add_argument('-o', '--out', required=True)
    p.add_argument('--size', type=int, default=1024)
    p.add_argument('--num-train', type=int, default=8)
    p.add_argument('--num-val', type=int, default=2)
    p.add_argument('--num-classes', type=int, default=6)
    p.add_argument('--seed', type=int, default=0)
    return p.parse_args(args)


def main(args=None):
    a = parse_args(args)
    rs = np.random.RandomState(a.seed)
    palette = class_tints(a.num_classes)
    for split, n in (('train', a.num_train), ('val', a.num_val)):
        os.makedirs(osp.join(a.out, 'img_dir', split), exist_ok=True)
        os.makedirs(osp.join(a.out, 'ann_dir', split), exist_ok=True)
        for i in range(n):
            ann = blobby_labels(rs, a.size, a.num_classes)
            noise = rs.randint(0, 255, (a.size, a.size, 3))
            tint = palette[ann.astype(np.int64)]
            img = np.clip(0.5 * noise + 0.5 * tint, 0, 255).astype(np.uint8)
            write_png(osp.join(a.out, 'img_dir', split, f't{i}.png'), img)
            write_png(osp.join(a.out, 'ann_dir', split, f't{i}.png'), ann)
    print(f'synthetic dataset at {a.out}')


if __name__ == '__main__':
    main()
