"""ClassMix and the strong augmentation, batched on the device (port of
``pfst_tpu/models/utils/dacs_transforms.py``), on NCHW tensors.

The random draws are kept apart from the arithmetic:
``sample_strong_draws`` takes them from a ``torch.Generator`` (per-image
class scores, the batch-shared jitter and blur gates, per-image jitter
factors and blur sigmas), and every other function applies given draws
to the whole batch at once. The JAX file's semantics:

* ``get_class_masks`` picks, per image, ceil(n/2) of the n classes
  present in the whole batch, 255 included
  (``dacs_transforms.py:42-81``);
* ``strong_transform``: one_mix, then color jitter on [0, 1] images
  (brightness, contrast, saturation, hue via HSV) when the jitter gate
  exceeds ``color_jitter_p``, then a separable Gaussian blur with
  reflect-101 borders when the blur gate exceeds 0.5
  (``dacs_transforms.py:232-281``).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def denorm(img, mean, std):
    """normalized -> [0, 1] (``mean``/``std`` per channel, 0-255 scale)."""
    return (img * std + mean) / 255.0


def renorm(img, mean, std):
    return (img * 255.0 - mean) / std


def _channel_view(v, img):
    return torch.as_tensor(v, dtype=img.dtype, device=img.device).view(
        1, -1, 1, 1)


# ---------------------------------------------------------------------
# Draws
# ---------------------------------------------------------------------
def sample_strong_draws(generator: torch.Generator, batch_size: int,
                        num_classes: int, color_jitter_s: float = 0.2,
                        blur: bool = True) -> dict:
    """The random numbers of one ClassMix + strong-augmentation pass, on
    the CPU: ``class_scores`` (B, num_classes + 1) U(0, 1);
    ``jitter_gate`` and ``blur_gate`` (Python floats, shared by the
    batch; ``blur_gate`` is 0 without blur); ``jitter`` (B, 4)
    brightness, contrast and saturation factors U(max(0, 1 - s), 1 + s)
    and the hue shift U(-min(s, 0.5), min(s, 0.5)); ``blur_sigma`` (B,)
    U(0.15, 1.15)."""
    g = generator
    scores = torch.rand((batch_size, num_classes + 1), generator=g)
    jitter_gate = float(torch.rand((), generator=g))
    blur_gate = float(torch.rand((), generator=g)) if blur else 0.0
    lo, hi, hue = max(0.0, 1.0 - color_jitter_s), 1.0 + color_jitter_s, \
        min(color_jitter_s, 0.5)
    u = torch.rand((batch_size, 4), generator=g)
    jitter = torch.cat([lo + (hi - lo) * u[:, :3],
                        -hue + 2.0 * hue * u[:, 3:]], dim=1)
    sigma = 0.15 + torch.rand((batch_size,), generator=g)
    return dict(class_scores=scores, jitter_gate=jitter_gate,
                blur_gate=blur_gate, jitter=jitter, blur_sigma=sigma)


# ---------------------------------------------------------------------
# ClassMix
# ---------------------------------------------------------------------
def _class_index(labels, num_classes):
    lbl = torch.where(labels == 255, num_classes, labels).long()
    return lbl.clamp(0, num_classes)


def class_presence(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(num_classes + 1,) presence over the whole batch; the last slot is
    255."""
    hist = torch.bincount(_class_index(labels, num_classes).reshape(-1),
                          minlength=num_classes + 1)
    return hist > 0


def get_class_masks(scores: torch.Tensor, labels: torch.Tensor,
                    num_classes: int) -> torch.Tensor:
    """(B, H, W) float masks: per image, 1 where the pixel's class is
    among the ceil(n/2) batch-present classes with the largest
    ``scores`` (B, num_classes + 1)."""
    present = class_presence(labels, num_classes)
    scores = torch.where(present, scores.to(labels.device), -1.0)
    n_present = present.sum()
    n_choose = (n_present + n_present % 2) // 2
    order = torch.argsort(-scores, dim=1, stable=True)
    ranks = torch.argsort(order, dim=1)
    chosen = (ranks < n_choose) & present                 # (B, C + 1)
    lbl = _class_index(labels, num_classes)
    return chosen.gather(1, lbl.flatten(1)).view(lbl.shape).float()


def one_mix(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """``mask * a + (1 - mask) * b``; ``mask`` (B, H, W) broadcast over
    the channels of NCHW data."""
    m = mask[:, None] if a.ndim == mask.ndim + 1 else mask
    return m * a + (1.0 - m) * b


# ---------------------------------------------------------------------
# Color jitter on [0, 1] NCHW images, per-image factors (B,)
# ---------------------------------------------------------------------
_RGB_WEIGHTS = (0.299, 0.587, 0.114)


def _rgb_to_gray(img):
    w = _channel_view(_RGB_WEIGHTS, img)
    return (img * w).sum(dim=1, keepdim=True)


def _per_image(f, img):
    return f.to(img.device, img.dtype).view(-1, 1, 1, 1)


def adjust_brightness(img, factor):
    return torch.clamp(img * _per_image(factor, img), 0.0, 1.0)


def adjust_contrast(img, factor):
    mean = _rgb_to_gray(img).mean(dim=(1, 2, 3), keepdim=True)
    return torch.clamp(mean + _per_image(factor, img) * (img - mean),
                       0.0, 1.0)


def adjust_saturation(img, factor):
    gray = _rgb_to_gray(img)
    return torch.clamp(gray + _per_image(factor, img) * (img - gray),
                       0.0, 1.0)


def rgb_to_hsv(img):
    r, g, b = img[:, 0], img[:, 1], img[:, 2]
    maxc = img.amax(dim=1)
    minc = img.amin(dim=1)
    v = maxc
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / torch.clamp(maxc, min=1e-8), 0.0)
    dz = torch.clamp(delta, min=1e-8)
    rc = (maxc - r) / dz
    gc = (maxc - g) / dz
    bc = (maxc - b) / dz
    h = torch.where(r == maxc, bc - gc,
                    torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.remainder(h / 6.0, 1.0)
    h = torch.where(delta == 0, 0.0, h)
    return torch.stack([h, s, v], dim=1)


def hsv_to_rgb(img):
    """Branch-free HSV -> RGB (the k-formula of the JAX file)."""
    h, s, v = img[:, 0], img[:, 1], img[:, 2]

    def channel(n):
        k = torch.remainder(n + h * 6.0, 6.0)
        return v - v * s * torch.clamp(torch.minimum(k, 4.0 - k), 0.0, 1.0)

    return torch.stack([channel(5.0), channel(3.0), channel(1.0)], dim=1)


def adjust_hue(img, shift):
    hsv = rgb_to_hsv(img)
    h = torch.remainder(hsv[:, 0] + _per_image(shift, img)[:, 0], 1.0)
    return hsv_to_rgb(torch.stack([h, hsv[:, 1], hsv[:, 2]], dim=1))


def color_jitter(img, factors):
    """Brightness, contrast, saturation, then hue; ``factors`` (B, 4)."""
    img = adjust_brightness(img, factors[:, 0])
    img = adjust_contrast(img, factors[:, 1])
    img = adjust_saturation(img, factors[:, 2])
    return adjust_hue(img, factors[:, 3])


# ---------------------------------------------------------------------
# Gaussian blur
# ---------------------------------------------------------------------
def blur_kernel_size(h: int, w: int) -> Tuple[int, int]:
    """The reference kernel-size formula (``dacs_transforms.py:171-178``):
    51 taps at 512."""

    def one(n):
        return int(math.floor(math.ceil(0.1 * n) - 0.5 +
                              math.ceil(0.1 * n) % 2))

    return max(one(h), 1), max(one(w), 1)


def blur_matrix(n: int, k: int, sigma: torch.Tensor) -> torch.Tensor:
    """(B, n, n) banded Gaussian operators, one per ``sigma`` (B,), with
    reflect-101 borders (``dacs_transforms.py:181-201``)."""
    pad = k // 2
    taps = torch.arange(k, dtype=torch.float32, device=sigma.device) - pad
    g = torch.exp(-(taps**2) / (2.0 * sigma.float()[:, None]**2))
    g = g / g.sum(dim=1, keepdim=True)                     # (B, k)
    rows = torch.arange(n, device=sigma.device)[:, None]
    pos = (rows + torch.arange(-pad, pad + 1, device=sigma.device)).abs()
    pos = ((n - 1) - ((n - 1) - pos).abs()).abs()           # (n, k)
    mat = torch.zeros((sigma.shape[0], n, n), device=sigma.device)
    return mat.scatter_add_(2, pos.expand(sigma.shape[0], n, k),
                            g[:, None, :].expand(-1, n, k).contiguous())


def gaussian_blur(img: torch.Tensor, sigma: torch.Tensor,
                  ksize: Tuple[int, int]) -> torch.Tensor:
    """Separable Gaussian blur of NCHW ``img`` with per-image ``sigma``
    (B,), rows then columns, as two batched matrix products."""
    b, _, h, w = img.shape
    sigma = sigma.to(img.device)
    ay = blur_matrix(h, ksize[0], sigma)
    ax = blur_matrix(w, ksize[1], sigma)
    out = torch.einsum('bih,bchw->bciw', ay, img.float())
    out = torch.einsum('bjw,bciw->bcij', ax, out)
    return out.to(img.dtype)


# ---------------------------------------------------------------------
# strong_transform: mix + jitter + blur over the batch
# ---------------------------------------------------------------------
def strong_transform(draws: dict,
                     mix_mask: torch.Tensor,
                     data_pair: Optional[Tuple[torch.Tensor,
                                               torch.Tensor]] = None,
                     target_pair: Optional[Tuple[torch.Tensor,
                                                 torch.Tensor]] = None,
                     color_jitter_p: float = 0.2,
                     mean=None, std=None,
                     denorm_type: str = 'mean_std'):
    """The batch's strong transform under the given ``draws``.
    ``data_pair`` / ``target_pair`` are (source, target) NCHW images /
    (B, H, W) maps. Returns (data, target)."""
    data = target = None
    if data_pair is not None:
        data = one_mix(mix_mask, *data_pair)
    if target_pair is not None:
        target = one_mix(mix_mask, *target_pair)
    if data is not None and data.shape[1] == 3:
        if draws['jitter_gate'] > color_jitter_p:
            if denorm_type == 'mean_std':
                m, s = _channel_view(mean, data), _channel_view(std, data)
                data = renorm(color_jitter(denorm(data, m, s),
                                           draws['jitter']), m, s)
            else:
                data = color_jitter(data, draws['jitter'])
        if draws['blur_gate'] > 0.5:
            data = gaussian_blur(data, draws['blur_sigma'],
                                 blur_kernel_size(*data.shape[2:]))
    return data, target
