"""Host-side geometric and photometric transforms of the leaf configs'
pipelines (port of ``pfst_tpu/datasets/pipelines/transforms.py``; mirrors
``rsiseg/datasets/pipelines/transforms.py`` and ``rsi_aug.py``).

Numpy plus the port's C++ host kernels (``native/hostaug.cc``), no cv2:

* ``imresize`` reproduces ``cv2.resize`` bit-exactly: INTER_NEAREST takes
  OpenCV's source offsets; INTER_LINEAR on uint8 OpenCV's offsets and
  11-bit fixed-point weights (computed here in OpenCV's float32 steps)
  with its integer arithmetic in ``hostaug.cc``, and on float32 images of
  two or more rows and columns OpenCV 5's float weights and its
  ``fma(S1 - S0, f, S0)`` passes (``hostaug.cc``);
* the photometric steps are 256-entry LUTs (``lut[img]``) and the fused
  HSV round trip of ``hostaug.cc``, bit-exact to cv2 at widths that are
  multiples of 32;
* ``RandomRotate`` takes ``cv2.getRotationMatrix2D``'s matrix (float64,
  here) and OpenCV's float64 inversion, and warps with ``hostaug.cc``'s
  ``cv2.warpAffine`` (bilinear on the image, nearest on the label maps,
  constant border; uint8, uint16 and float32); ``CLAHE`` is
  ``hostaug.cc``'s ``cv::CLAHE`` and ``AdjustGamma`` its ``cv2.LUT`` on
  uint8; all bit-exact to cv2 5.0 (``tests/test_torch_a12_rest.py``);
* the float transforms (``PercentileNormalize``, ``Rerange``,
  ``RGB2Gray``, ``MultiDomainClipNormalize``) are the JAX file's numpy.

Every class draws from ``np.random`` in the JAX file's order. One
difference, after rsiseg: ``Resize`` draws its ratio-range scale whenever
the sample has no ``scale`` yet. The JAX file takes the ``scale_factor``
of 1.0 that ``LoadImageFromFile`` records for a test-time ratio and so
never draws it in a training pipeline (ROADMAP C2); here the ratio mode of
``MultiScaleFlipAug`` sets ``scale`` itself.
"""
from __future__ import annotations

import math

import numpy as np

from ...native import hostaug
from ..builder import PIPELINES

_COEF_SCALE = np.float32(2048)  # OpenCV's INTER_RESIZE_COEF_SCALE


def _linear_coeffs(dst: int, src: int, clamp: bool):
    """OpenCV's INTER_LINEAR offsets and weights along one axis:
    ``f = float32((d + 0.5) * scale - 0.5)``, the source index its floor,
    the weights ``round((1 - frac) * 2048)`` and ``round(frac * 2048)``.
    Columns (``clamp``) outside the image take the edge with weights
    (2048, 0); rows keep their weights and read the clipped rows."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5) \
        .astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    if clamp:
        f[(s < 0) | (s >= src - 1)] = 0
        s = np.clip(s, 0, src - 1)
    w = np.stack([np.rint((np.float32(1) - f) * _COEF_SCALE),
                  np.rint(f * _COEF_SCALE)], axis=1).astype(np.int16)
    return s, w


def _linear_map(dst: int, src: int, clamp: bool):
    """OpenCV 5's INTER_LINEAR map of float32 images along one axis: the
    coordinate ``(d + 0.5) * scale - 0.5`` in float64, its source index
    the floor of its float32 value, the weight of the next index the
    float32 of the float64 remainder. Columns (``clamp``) outside the
    image read the edge; rows read the clipped rows with their weights.
    Returns (first index, second index, second weight)."""
    scale = 1.0 / (dst / src)
    f = (np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5
    s = np.floor(f.astype(np.float32)).astype(np.int64)
    frac = (f - s).astype(np.float32)
    if clamp:
        frac[(s < 0) | (s >= src - 1)] = 0
        s = np.clip(s, 0, src - 1)
        return s, np.minimum(s + 1, src - 1), frac
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), frac


def imresize(img, size_wh, interpolation='bilinear'):
    """``cv2.resize(img, size_wh)`` with INTER_LINEAR ('bilinear') or
    INTER_NEAREST ('nearest'), bit-exact on uint8 images and on float32
    images of two or more rows and columns (nearest on any dtype)."""
    w, h = int(size_wh[0]), int(size_wh[1])
    src_h, src_w = img.shape[:2]
    if (h, w) == (src_h, src_w):
        return img.copy()
    if interpolation == 'nearest':
        xofs = np.minimum(np.floor(np.arange(w) * (1.0 / (w / src_w))),
                          src_w - 1).astype(np.int64)
        yofs = np.minimum(np.floor(np.arange(h) * (1.0 / (h / src_h))),
                          src_h - 1).astype(np.int64)
        if img.dtype == np.uint8:
            return hostaug.resize_nearest(img, xofs, yofs)
        return img[yofs[:, None], xofs[None, :]]
    if interpolation != 'bilinear':
        raise NotImplementedError(f'{interpolation} resize is not ported')
    if img.dtype == np.float32 and min(h, w, src_h, src_w) >= 2:
        return hostaug.resize_linear_f32(img, _linear_map(w, src_w, True),
                                         _linear_map(h, src_h, False))
    if img.dtype != np.uint8:
        raise NotImplementedError(
            f'bilinear resize of {img.dtype} images of {img.shape[:2]} to '
            f'{(h, w)} is not ported (uint8, or float32 of two or more rows '
            f'and columns)')
    xofs, alpha = _linear_coeffs(w, src_w, clamp=True)
    ys, beta = _linear_coeffs(h, src_h, clamp=False)
    yofs = np.stack([np.clip(ys, 0, src_h - 1),
                     np.clip(ys + 1, 0, src_h - 1)], axis=1)
    return hostaug.resize_linear(img, (h, w), xofs, alpha, yofs, beta)


def imrescale(img, scale, interpolation='bilinear'):
    """Resize keeping the aspect so the image fits ``scale`` (mmcv's
    long/short edge rule)."""
    h, w = img.shape[:2]
    if isinstance(scale, (int, float)):
        factor = scale
    else:
        max_long, max_short = max(scale), min(scale)
        factor = min(max_long / max(h, w), max_short / min(h, w))
    new_size = (int(w * factor + 0.5), int(h * factor + 0.5))
    return imresize(img, new_size, interpolation), factor


@PIPELINES.register_module()
class Resize:
    """(``transforms.py:12``) multi-scale resize with ratio jitter."""

    def __init__(self, img_scale=None, multiscale_mode='range',
                 ratio_range=None, keep_ratio=True,
                 min_size=None, override_scale=False):
        if img_scale is None:
            self.img_scale = None
        elif isinstance(img_scale, list):
            self.img_scale = [tuple(s) for s in img_scale]
        else:
            self.img_scale = [tuple(img_scale)]
        self.multiscale_mode = multiscale_mode
        self.ratio_range = ratio_range
        self.keep_ratio = keep_ratio
        self.min_size = min_size
        self.override_scale = override_scale

    def _random_scale(self, results):
        if self.ratio_range is not None:
            if self.img_scale is None:
                h, w = results['img'].shape[:2]
                base = (w, h)
            else:
                base = self.img_scale[0]
            lo, hi = self.ratio_range
            ratio = np.random.random_sample() * (hi - lo) + lo
            scale = (int(base[0] * ratio), int(base[1] * ratio))
        elif len(self.img_scale) == 1:
            scale = self.img_scale[0]
        elif self.multiscale_mode == 'range':
            long_edges = [max(s) for s in self.img_scale]
            short_edges = [min(s) for s in self.img_scale]
            long_e = np.random.randint(min(long_edges),
                                       max(long_edges) + 1)
            short_e = np.random.randint(min(short_edges),
                                        max(short_edges) + 1)
            scale = (long_e, short_e)
        else:  # 'value'
            scale = self.img_scale[np.random.randint(len(self.img_scale))]
        results['scale'] = scale

    def __call__(self, results):
        if 'scale' not in results or self.override_scale:
            self._random_scale(results)
        img = results['img']
        if self.keep_ratio:
            img, factor = imrescale(img, results['scale'])
            scale_factor = np.array([factor, factor, factor, factor],
                                    np.float32)
        else:
            wq, hq = results['scale']
            h, w = img.shape[:2]
            img = imresize(img, (wq, hq))
            scale_factor = np.array([wq / w, hq / h, wq / w, hq / h],
                                    np.float32)
        results['img'] = img
        results['img_shape'] = img.shape
        results['pad_shape'] = img.shape
        results['scale_factor'] = scale_factor
        results['keep_ratio'] = self.keep_ratio
        size_wh = (img.shape[1], img.shape[0])
        for key in results.get('seg_fields', []):
            results[key] = imresize(results[key], size_wh, 'nearest')
        return results

    def __repr__(self):
        return (f'{self.__class__.__name__}(img_scale={self.img_scale}, '
                f'ratio_range={self.ratio_range}, '
                f'keep_ratio={self.keep_ratio})')


@PIPELINES.register_module()
class RandomCrop:
    """(``transforms.py:645-737``) crop with a single-class cap: up to 10
    re-draws until no class (ignore excluded) covers ``cat_max_ratio``."""

    def __init__(self, crop_size, cat_max_ratio=1.0, ignore_index=255):
        assert crop_size[0] > 0 and crop_size[1] > 0
        self.crop_size = tuple(crop_size)
        self.cat_max_ratio = cat_max_ratio
        self.ignore_index = ignore_index

    def get_crop_bbox(self, img):
        margin_h = max(img.shape[0] - self.crop_size[0], 0)
        margin_w = max(img.shape[1] - self.crop_size[1], 0)
        offset_h = np.random.randint(0, margin_h + 1)
        offset_w = np.random.randint(0, margin_w + 1)
        return (offset_h, offset_h + self.crop_size[0],
                offset_w, offset_w + self.crop_size[1])

    @staticmethod
    def crop(img, bbox):
        y1, y2, x1, x2 = bbox
        return img[y1:y2, x1:x2, ...]

    def __call__(self, results):
        img = results['img']
        crop_bbox = self.get_crop_bbox(img)
        if self.cat_max_ratio < 1.0 and 'gt_semantic_seg' in results:
            for _ in range(10):
                seg = self.crop(results['gt_semantic_seg'], crop_bbox)
                if seg.dtype == np.uint8:
                    cnt = np.bincount(seg.reshape(-1), minlength=256)
                    if 0 <= self.ignore_index < 256:
                        cnt[self.ignore_index] = 0
                    cnt = cnt[cnt > 0]
                else:
                    labels, cnt = np.unique(seg, return_counts=True)
                    cnt = cnt[labels != self.ignore_index]
                if len(cnt) > 1 and \
                        cnt.max() / cnt.sum() < self.cat_max_ratio:
                    break
                crop_bbox = self.get_crop_bbox(img)
        results['img'] = self.crop(img, crop_bbox)
        results['img_shape'] = results['img'].shape
        results['crop_bbox'] = crop_bbox
        for key in results.get('seg_fields', []):
            results[key] = self.crop(results[key], crop_bbox)
        for key in results.get('img_fields', []):
            if key != 'img':
                results[key] = self.crop(results[key], crop_bbox)
        return results

    def __repr__(self):
        return f'{self.__class__.__name__}(crop_size={self.crop_size})'


@PIPELINES.register_module()
class RandomFlip:
    """(``transforms.py:263``) records the flip and its directions."""

    def __init__(self, prob=None, flip_ratio=None,
                 direction='horizontal'):
        self.prob = prob if prob is not None else flip_ratio
        assert direction in ('horizontal', 'vertical')
        self.direction = direction

    def __call__(self, results):
        flip = np.random.rand() < (self.prob or 0)
        if flip:
            axis = 1 if self.direction == 'horizontal' else 0
            for key in results.get('img_fields', ['img']):
                results[key] = np.flip(results[key], axis=axis).copy()
            for key in results.get('seg_fields', []):
                results[key] = np.flip(results[key], axis=axis).copy()
        # consecutive RandomFlips (vertical, then horizontal) accumulate
        # their directions
        prev = results.get('flip_direction')
        if flip:
            if isinstance(prev, list):
                prev = prev + [self.direction]
            elif isinstance(prev, str):
                prev = [prev, self.direction]
            else:
                prev = self.direction
        results['flip'] = bool(results.get('flip', False) or flip)
        results['flip_direction'] = prev
        return results

    def __repr__(self):
        return (f'{self.__class__.__name__}(prob={self.prob}, '
                f'direction={self.direction})')


@PIPELINES.register_module()
class RandomRotate90:
    """(``rsi_aug.py:30``) rotate by k*90 degrees, records ``rotate_k``."""

    def __init__(self, prob=1.0):
        self.prob = prob

    def __call__(self, results):
        rot_k = 0
        if np.random.rand() < self.prob:
            rot_k = int(np.random.choice([0, 1, 2, 3]))
            if rot_k:
                for key in results.get('img_fields', ['img']):
                    results[key] = np.ascontiguousarray(
                        np.rot90(results[key], k=rot_k))
                for key in results.get('seg_fields', []):
                    results[key] = np.ascontiguousarray(
                        np.rot90(results[key], k=rot_k))
                results['img_shape'] = results['img'].shape
        results['rotate_k'] = rot_k
        return results

    def __repr__(self):
        return f'{self.__class__.__name__}(prob={self.prob})'


def rotation_matrix(center, angle: float, scale: float = 1.0):
    """``cv2.getRotationMatrix2D``: the (2, 3) float64 map rotating by
    ``angle`` degrees (counter-clockwise) about ``center``, a float32
    point as OpenCV takes it."""
    cx, cy = (float(np.float32(c)) for c in center)
    angle = angle * (math.pi / 180)
    alpha = math.cos(angle) * scale
    beta = math.sin(angle) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def invert_affine(m) -> np.ndarray:
    """The inverse of a (2, 3) affine map as ``cv2.warpAffine`` computes
    it, in float64."""
    m = np.asarray(m, np.float64).reshape(6).tolist()
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[1], m[3], m[4] = a11, m[1] * -d, m[3] * -d, a22
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return np.array(m).reshape(2, 3)


def warp_affine(img, m, size_wh, nearest=False, border_value=0):
    """``cv2.warpAffine(img, m, size_wh, flags, borderValue=border_value)``
    of a uint8, uint16 or float32 image, INTER_LINEAR or (``nearest``)
    INTER_NEAREST, with a constant border: a number is OpenCV's
    ``Scalar(v)``, the value of the first channel with 0 in the others,
    saturated to the image's dtype."""
    cn = 1 if img.ndim == 2 else img.shape[2]
    border = list(border_value) if isinstance(border_value, (list, tuple)) \
        else [border_value]
    border = np.array((border + [0] * cn)[:cn], np.float64)
    if img.dtype != np.float32:
        info = np.iinfo(img.dtype)
        border = np.clip(np.rint(border), info.min, info.max)
    return hostaug.warp_affine(img, invert_affine(m), size_wh, nearest,
                               border.astype(img.dtype))


@PIPELINES.register_module()
class RandomRotate:
    """(``transforms.py:251-278``) rotation by an angle drawn from
    ``degree`` with probability ``prob``, about ``center`` (the image's
    centre by default): the image bilinear with ``pad_val`` outside, the
    label maps nearest with ``seg_pad_val``. ``auto_bound`` is accepted
    and unused, as in the JAX file."""

    def __init__(self, prob, degree, pad_val=0, seg_pad_val=255,
                 center=None, auto_bound=False):
        self.prob = prob
        self.degree = (-degree, degree) if isinstance(
            degree, (int, float)) else tuple(degree)
        self.pad_val = pad_val
        self.seg_pad_val = seg_pad_val
        self.center = center
        self.auto_bound = auto_bound

    def __call__(self, results):
        if np.random.rand() < self.prob:
            angle = np.random.uniform(*self.degree)
            h, w = results['img'].shape[:2]
            center = self.center or ((w - 1) * 0.5, (h - 1) * 0.5)
            m = rotation_matrix(center, -angle, 1.0)
            results['img'] = warp_affine(results['img'], m, (w, h),
                                         border_value=self.pad_val)
            for key in results.get('seg_fields', []):
                results[key] = warp_affine(results[key], m, (w, h),
                                           nearest=True,
                                           border_value=self.seg_pad_val)
        return results

    def __repr__(self):
        return (f'{self.__class__.__name__}(prob={self.prob}, '
                f'degree={self.degree})')


@PIPELINES.register_module()
class Pad:
    """(``transforms.py:332``) bottom/right pad to a fixed size or a size
    divisor. ``img_shape`` keeps the unpadded shape, which the train loop
    reads to put a deferred-normalization pad at 0 in normalized space."""

    def __init__(self, size=None, size_divisor=None, pad_val=0,
                 seg_pad_val=255):
        self.size = tuple(size) if size is not None else None
        self.size_divisor = size_divisor
        self.pad_val = pad_val
        self.seg_pad_val = seg_pad_val

    @staticmethod
    def _pad(img, target, val):
        ph = max(target[0] - img.shape[0], 0)
        pw = max(target[1] - img.shape[1], 0)
        pad_width = [(0, ph), (0, pw)] + [(0, 0)] * (img.ndim - 2)
        return np.pad(img, pad_width, constant_values=val)

    def __call__(self, results):
        if self.size is not None:
            target = self.size
        else:
            d = self.size_divisor
            h, w = results['img'].shape[:2]
            target = (-(-h // d) * d, -(-w // d) * d)
        for key in results.get('img_fields', ['img']):
            results[key] = self._pad(results[key], target, self.pad_val)
        # the clean snapshot (``KeepOriImage``) stays shape-aligned with img
        if 'ori_img' in results:
            results['ori_img'] = self._pad(results['ori_img'], target,
                                           self.pad_val)
        for key in results.get('seg_fields', []):
            results[key] = self._pad(results[key], target,
                                     self.seg_pad_val)
        results['pad_shape'] = results['img'].shape
        results['pad_fixed_size'] = self.size
        results['pad_size_divisor'] = self.size_divisor
        return results

    def __repr__(self):
        return f'{self.__class__.__name__}(size={self.size})'


@PIPELINES.register_module()
class Normalize:
    """(``transforms.py:405``) (x - mean) / std, optional BGR -> RGB."""

    def __init__(self, mean, std, to_rgb=True):
        self.mean = np.array(mean, np.float32)
        self.std = np.array(std, np.float32)
        self.to_rgb = to_rgb

    def _norm(self, img):
        img = img.astype(np.float32)
        if self.to_rgb and img.ndim == 3 and img.shape[2] == 3:
            img = img[..., ::-1]
        return (img - self.mean) / self.std

    def __call__(self, results):
        for key in results.get('img_fields', ['img']):
            results[key] = self._norm(results[key])
        if 'ori_img' in results:
            results['ori_img'] = self._norm(results['ori_img'])
        results['img_norm_cfg'] = dict(mean=self.mean, std=self.std,
                                       to_rgb=self.to_rgb)
        return results

    def __repr__(self):
        return (f'{self.__class__.__name__}(mean={self.mean.tolist()}, '
                f'std={self.std.tolist()}, to_rgb={self.to_rgb})')


@PIPELINES.register_module()
class DeferNormalize:
    """Normalization on the card: images stay on the 0-255 scale (uint8,
    or float16) for the host-to-device copy, after the BGR -> RGB flip,
    and the step normalizes them (``maybe_normalize_images``). Takes the
    place of ``Normalize`` where ``cfg.data.device_normalize`` is set
    (``apis/train.py::apply_device_normalize``)."""

    def __init__(self, mean, std, to_rgb=True, wire_dtype='uint8'):
        self.mean = np.array(mean, np.float32)
        self.std = np.array(std, np.float32)
        self.to_rgb = to_rgb
        if wire_dtype not in ('float16', 'uint8'):
            raise ValueError(f'unknown wire dtype {wire_dtype!r}')
        self.wire_dtype = wire_dtype

    def _prep(self, img):
        if self.to_rgb and img.ndim == 3 and img.shape[2] == 3:
            img = img[..., ::-1]
        if self.wire_dtype == 'uint8':
            if img.dtype == np.uint8:   # what round and clip would give
                return np.ascontiguousarray(img)
            return np.clip(np.round(img), 0, 255).astype(np.uint8)
        return np.ascontiguousarray(img, np.float16)

    def __call__(self, results):
        for key in results.get('img_fields', ['img']):
            results[key] = self._prep(results[key])
        if 'ori_img' in results:
            results['ori_img'] = self._prep(results['ori_img'])
        results['img_norm_cfg'] = dict(mean=self.mean, std=self.std,
                                       to_rgb=self.to_rgb, deferred=True)
        return results

    @staticmethod
    def swap_into(node, wire='uint8'):
        """Swap the first ``Normalize`` of a pipeline config tree (test
        pipelines nest it in ``MultiScaleFlipAug.transforms``) for
        ``DeferNormalize``; return the swapped transform, or None when the
        tree has no Normalize. A tree with a ``Pad`` is refused: its pad
        would land at -mean/std instead of 0 in normalized space."""
        if _find_type(node, 'Pad'):
            raise ValueError('deferred normalization of a pipeline with '
                             'Pad would move its pad off 0 in normalized '
                             'space')
        found = _find_type(node, 'Normalize')
        if found is not None:
            found['type'] = 'DeferNormalize'
            found['wire_dtype'] = wire
        return found

    def __repr__(self):
        return (f'{self.__class__.__name__}(mean={self.mean.tolist()},'
                f' std={self.std.tolist()}, to_rgb={self.to_rgb}, '
                f'wire_dtype={self.wire_dtype})')


@PIPELINES.register_module()
class ClipNormalize:
    """(``transforms.py:429-452``; reference ``transforms.py:1166-1212``,
    SeasonNet) clip each channel to mean +- 2 std and map it to [0, 1]
    in float32, BGR -> RGB with ``to_rgb``, and to uint8 by truncation of
    ``x * 255`` with ``to_uint8``. The mean and std are on the raw scale
    of the file; the images reach this transform as read (the 8-bit view
    of a 16-bit TIFF, as in the JAX pipeline, ROADMAP C2)."""

    def __init__(self, mean, std, to_rgb=True, axis=None, to_uint8=False):
        self.mean = np.array(mean, np.float32)
        self.std = np.array(std, np.float32)
        self.to_rgb = to_rgb
        self.to_uint8 = to_uint8

    def __call__(self, results):
        lo = self.mean.reshape(1, 1, -1) - 2 * self.std.reshape(1, 1, -1)
        hi = self.mean.reshape(1, 1, -1) + 2 * self.std.reshape(1, 1, -1)
        for key in results.get('img_fields', ['img']):
            img = results[key].astype(np.float32)
            img = np.clip((img - lo) / (hi - lo), 0, 1)
            if self.to_rgb and img.ndim == 3 and img.shape[2] == 3:
                img = img[:, :, [2, 1, 0]]
            if self.to_uint8:
                img = (img * 255).astype(np.uint8)
            results[key] = img
        results['img_norm_cfg'] = dict(mean=self.mean, std=self.std,
                                       to_rgb=self.to_rgb)
        return results

    def __repr__(self):
        return (f'{self.__class__.__name__}(mean={self.mean.tolist()}, '
                f'std={self.std.tolist()}, to_rgb={self.to_rgb}, '
                f'to_uint8={self.to_uint8})')


@PIPELINES.register_module()
class PercentileNormalize:
    """(``transforms.py:456-470``) each channel stretched between its
    ``lo`` and ``hi`` percentiles to [-1, 1], float32."""

    def __init__(self, lo=2, hi=98, to_rgb=False):
        self.lo, self.hi, self.to_rgb = lo, hi, to_rgb

    def __call__(self, results):
        for key in results.get('img_fields', ['img']):
            img = results[key].astype(np.float32)
            plo = np.percentile(img, self.lo, axis=(0, 1))
            phi = np.percentile(img, self.hi, axis=(0, 1))
            img = np.clip((img - plo) / np.maximum(phi - plo, 1e-6), 0, 1)
            results[key] = img * 2.0 - 1.0
        return results

    def __repr__(self):
        return f'{self.__class__.__name__}(lo={self.lo}, hi={self.hi})'


@PIPELINES.register_module()
class MultiDomainClipNormalize:
    """(``transforms.py:473-484``) the ``ClipNormalize`` of the sample's
    ``domain`` (else of ``default``)."""

    def __init__(self, norm_cfg_dict, default=None):
        self.norm_cfg_dict = {
            k: ClipNormalize(**v) for k, v in norm_cfg_dict.items()}
        self.default = default

    def __call__(self, results):
        domain = results.get('domain', self.default)
        return self.norm_cfg_dict[domain](results)

    def __repr__(self):
        return (f'{self.__class__.__name__}('
                f'domains={sorted(self.norm_cfg_dict)})')


@PIPELINES.register_module()
class Rerange:
    """(``transforms.py:487-499``) the image linearly onto [min_value,
    max_value], float32."""

    def __init__(self, min_value=0, max_value=255):
        self.min_value, self.max_value = min_value, max_value

    def __call__(self, results):
        img = results['img'].astype(np.float32)
        lo, hi = img.min(), img.max()
        img = (img - lo) / max(hi - lo, 1e-6)
        results['img'] = img * (self.max_value - self.min_value) + \
            self.min_value
        return results

    def __repr__(self):
        return (f'{self.__class__.__name__}(min_value={self.min_value}, '
                f'max_value={self.max_value})')


@PIPELINES.register_module()
class CLAHE:
    """(``transforms.py:502-516``) contrast-limited adaptive histogram
    equalisation of each channel, in place, as a uint8 plane:
    ``cv2.createCLAHE(clip_limit, tile_grid_size).apply`` by
    ``hostaug.cc``."""

    def __init__(self, clip_limit=40.0, tile_grid_size=(8, 8)):
        self.clip_limit = clip_limit
        self.tile_grid_size = tuple(tile_grid_size)

    def __call__(self, results):
        img = results['img']
        for c in range(img.shape[2]):
            img[:, :, c] = hostaug.clahe(np.array(img[:, :, c], np.uint8),
                                         self.clip_limit,
                                         self.tile_grid_size)
        results['img'] = img
        return results

    def __repr__(self):
        return (f'{self.__class__.__name__}(clip_limit={self.clip_limit}, '
                f'tile_grid_size={self.tile_grid_size})')


@PIPELINES.register_module()
class RGB2Gray:
    """(``transforms.py:519-533``) the weighted sum of the first three
    channels, tiled ``out_channels`` (else the input's count) times,
    float32."""

    def __init__(self, out_channels=None, weights=(0.299, 0.587, 0.114)):
        self.out_channels = out_channels
        self.weights = np.array(weights, np.float32)

    def __call__(self, results):
        img = results['img']
        gray = (img[..., :3].astype(np.float32) *
                self.weights).sum(-1, keepdims=True)
        reps = self.out_channels or img.shape[2]
        results['img'] = np.tile(gray, (1, 1, reps))
        results['img_shape'] = results['img'].shape
        return results

    def __repr__(self):
        return (f'{self.__class__.__name__}(out_channels='
                f'{self.out_channels}, weights={self.weights.tolist()})')


@PIPELINES.register_module()
class AdjustGamma:
    """(``transforms.py:536-548``) the image through the LUT ``(i / 255)
    ** (1 / gamma) * 255``, truncated to uint8 (``cv2.LUT`` by
    ``hostaug.cc``)."""

    def __init__(self, gamma=1.0):
        self.gamma = gamma
        inv = 1.0 / gamma
        self.table = np.array([(i / 255.0)**inv * 255
                               for i in range(256)]).astype(np.uint8)

    def __call__(self, results):
        results['img'] = hostaug.apply_lut(
            np.array(results['img'], np.uint8), self.table)
        return results

    def __repr__(self):
        return f'{self.__class__.__name__}(gamma={self.gamma})'


@PIPELINES.register_module()
class SegRescale:
    """(``transforms.py:551-565``) every label map resized by
    ``scale_factor``, nearest."""

    def __init__(self, scale_factor=1):
        self.scale_factor = scale_factor

    def __call__(self, results):
        for key in results.get('seg_fields', []):
            if self.scale_factor != 1:
                seg = results[key]
                h, w = seg.shape[:2]
                results[key] = imresize(
                    seg, (int(w * self.scale_factor),
                          int(h * self.scale_factor)), 'nearest')
        return results

    def __repr__(self):
        return f'{self.__class__.__name__}(scale_factor={self.scale_factor})'


@PIPELINES.register_module()
class Uint82Float:
    """(``transforms.py:568-574``) every image field to float32, on its
    0-255 scale."""

    def __call__(self, results):
        for key in results.get('img_fields', ['img']):
            results[key] = results[key].astype(np.float32)
        return results

    def __repr__(self):
        return f'{self.__class__.__name__}()'


def _find_type(node, type_name):
    """The first transform config of ``type_name`` in a config tree."""
    if isinstance(node, dict):
        if node.get('type') == type_name:
            return node
        node = list(node.values())
    if isinstance(node, (list, tuple)):
        for v in node:
            found = _find_type(v, type_name)
            if found is not None:
                return found
    return None


_IOTA = np.arange(256, dtype=np.uint8)


def _affine_lut(lut, alpha=1.0, beta=0.0):
    """``clip(x * alpha + beta)`` in float32 as a 256-entry uint8 LUT,
    composed after ``lut``."""
    step = np.clip(np.arange(256, dtype=np.float32) * alpha + beta,
                   0, 255).astype(np.uint8)
    return step[lut]


def _apply_lut(img, lut):
    return lut[np.asarray(img, np.uint8)]


class _Photometric:
    """Photometric distortion of a BGR uint8 image (``transforms.py:943``).

    Brightness (beta), contrast (alpha) and saturation (alpha) are each
    ``clip(float32(x) * a + b, 0, 255).astype(uint8)``, a pointwise map,
    applied as a 256-entry LUT; consecutive BGR-space maps compose into
    one table (``lut2[lut1]`` reproduces both roundings). Saturation and
    hue go through the fused HSV round trip of ``hostaug.cc``. The random
    draws are the JAX file's, in its order."""

    def __init__(self, brightness_delta=32, contrast_range=(0.5, 1.5),
                 saturation_range=(0.5, 1.5), hue_delta=18):
        self.brightness_delta = brightness_delta
        self.contrast_lower, self.contrast_upper = contrast_range
        self.saturation_lower, self.saturation_upper = saturation_range
        self.hue_delta = hue_delta

    def _apply(self, img):
        lut = _IOTA
        if np.random.randint(2):
            lut = _affine_lut(
                lut, beta=np.random.uniform(-self.brightness_delta,
                                            self.brightness_delta))
        mode = np.random.randint(2)
        if mode == 1:
            if np.random.randint(2):
                lut = _affine_lut(
                    lut, alpha=np.random.uniform(self.contrast_lower,
                                                 self.contrast_upper))
        if lut is not _IOTA:
            img = _apply_lut(img, lut)
        if np.random.randint(2):
            sat_lut = _affine_lut(
                _IOTA, alpha=np.random.uniform(self.saturation_lower,
                                               self.saturation_upper))
            img = hostaug.hsv_modify(img, sat_lut=sat_lut)
        if np.random.randint(2):
            delta = np.random.randint(-self.hue_delta, self.hue_delta)
            hue_lut = ((np.arange(256) + delta) % 180).astype(np.uint8)
            img = hostaug.hsv_modify(img, hue_lut=hue_lut)
        if mode == 0:
            if np.random.randint(2):
                lut = _affine_lut(
                    _IOTA, alpha=np.random.uniform(self.contrast_lower,
                                                   self.contrast_upper))
                img = _apply_lut(img, lut)
        return img


@PIPELINES.register_module()
class PhotoMetricDistortion(_Photometric):
    """(``transforms.py:943-1060``)."""

    def __call__(self, results):
        results['img'] = self._apply(results['img'])
        return results

    def __repr__(self):
        return f'{self.__class__.__name__}()'


@PIPELINES.register_module()
class StrongAugmentation(_Photometric):
    """Writes a second, independently distorted ``img_strong_aug`` view
    (``transforms.py:1062-1160``)."""

    def __call__(self, results):
        results['img_strong_aug'] = self._apply(results['img'].copy())
        results.setdefault('img_fields', ['img'])
        if 'img_strong_aug' not in results['img_fields']:
            results['img_fields'].append('img_strong_aug')
        return results

    def __repr__(self):
        return f'{self.__class__.__name__}()'


@PIPELINES.register_module()
class KeepOriImage:
    """The clean target view for PFSTV4's teacher (``transforms.py:692-
    720``): a copy of ``img`` after the resize and crop, before rot90,
    flips and the photometric steps, so that only the rot90 and flips
    need replaying in the step. It stays outside ``img_fields``, so the
    geometric transforms skip it; ``Normalize``, ``DeferNormalize`` and
    ``Pad`` treat it as they treat ``img``, and ``DefaultFormatBundle``
    adds the replay metas. ``UDADataset`` gives it to the batch as
    ``target_img_ori``. Place it after ``RandomCrop`` and before
    ``RandomRotate90`` / ``RandomFlip``; the replay is exact while
    ``Pad`` pads nothing (the resized image covers the crop)."""

    def __call__(self, results):
        results['ori_img'] = results['img'].copy()
        return results

    def __repr__(self):
        return f'{self.__class__.__name__}()'
