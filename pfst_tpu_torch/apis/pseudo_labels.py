"""The pseudo-label corpus generator (port of ``tools/gen_pseudo_labels.py``;
the sweep of rsiseg's ``PseudoLabelingHookV4``,
``rsiseg/core/hook/pseudo_labeling_hookv4.py:28-278``).

The two-phase self-training workflow: a source-only model labels the
target images, and a domain adaptor then trains on those labels through
``LoadAnnotationsPseudoLabelsV2(pseudo_labels_dir=...)``. Each image of
the split gets one HDF5 file (``datasets/pipelines/h5.py``), named after
its image, in the JAX tool's layout:

* ``seg_logits`` (C, H, W) float16: ``EncoderDecoder.encode_decode``'s
  logits at the test pipeline's size;
* ``thre@{ratio}`` (C,) float32 for the 11 ratios of ``RATIOS``: the
  corpus-wide entropy threshold of each predicted class below which that
  ratio of its pixels lies, from per-class histograms of 8192 bins over
  [0, log C] streamed through the sweep (``pseudo_labeling_hookv4.py:
  172-205``); inf for a class no pixel predicts;
* with ``save_feats``, ``feats_{lvl}`` (h, w, C) float16, the backbone's
  level ``lvl``, and ``gaussian_sim_feat_{lvl}`` (h, w, k*k) float16, its
  gaussian neighborhood similarity (``:154-163``, ``:210-234``) computed
  by ``ops.neighborhood_similarity`` (the hand-written kernel on the card)
  from the stored float16 features read back and widened to float32.

``sigmas.json`` holds, for each target mean similarity, the sigma that
gives it: a binary search over the squared neighbor distances of the
first 8 images' decoded features (``:236-278``). As in the JAX tool, the
sigma is solved on the decoded features and applied to backbone level
``lvl`` (ROADMAP C2). Inference, the entropy histograms and the distances
run on ``device``; the files are written from the host. Each file is
written whole after the sweep (logits and features), then rewritten once
with the thresholds and similarity maps added.
"""
from __future__ import annotations

import json
import os
import os.path as osp
import time
from typing import Dict, Iterable, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..datasets import build_dataset
from ..datasets.pipelines.h5 import read_h5, write_h5
from ..ops import neighborhood_similarity
from ..utils import Config
from ..utils.logger import get_root_logger, print_log
from .inference import init_segmentor
from .test import normalize_views

RATIOS = (0.01, 0.05, 0.1, 0.15, 0.2, 0.25, 0.3, 0.35, 0.4, 0.45, 0.5)
NBINS = 8192
SIGMA_SAMPLES = 8


def entropy_and_label(logits: torch.Tensor):
    """(C, H, W) logits -> (entropy, argmax label) of their softmax, each
    (H, W), computed in float32 as the JAX tool's ``entropy_of``."""
    x = logits.float()
    p = torch.exp(x - x.amax(0, keepdim=True))
    p = p / p.sum(0, keepdim=True)
    return -(p * torch.log(p + 1e-12)).sum(0), p.argmax(0)


def neighbor_sq_distances(x: torch.Tensor, kernel_size: int,
                          dilation: int) -> torch.Tensor:
    """(1, C, H, W) -> (k*k, H, W): the squared distance of each pixel's
    feature to each of its k x k dilated neighbors, zero padded (the JAX
    tool's ``unfold_neighbors`` form), in float32."""
    x = x.float()
    h, w = x.shape[2:]
    pad = (kernel_size // 2) * dilation
    xp = F.pad(x, (pad, pad, pad, pad))
    return torch.stack([
        ((xp[:, :, i * dilation:i * dilation + h,
             j * dilation:j * dilation + w] - x)**2).sum(1)[0]
        for i in range(kernel_size) for j in range(kernel_size)])


def solve_sigma(feats: Sequence[torch.Tensor], kernel_size: int,
                dilation: int, target_mean_sim: float) -> float:
    """The sigma in [1e-2, 1e4] whose mean gaussian neighborhood
    similarity ``exp(-d2 / sigma^2)`` over ``feats`` ((1, C, H, W) each)
    is ``target_mean_sim``: 60 bisection steps, as the JAX tool."""
    d2 = torch.cat([neighbor_sq_distances(f, kernel_size, dilation)
                    .reshape(-1) for f in feats])
    lo, hi = 1e-2, 1e4
    for _ in range(60):
        mid = (lo + hi) / 2
        if float(torch.exp(-d2 / mid**2).mean()) < target_mean_sim:
            lo = mid
        else:
            hi = mid
    return (lo + hi) / 2


def thresholds_from_histograms(class_hist: np.ndarray,
                               ent_max: float) -> Dict[float, np.ndarray]:
    """Per ratio, each class's threshold: the upper edge of the first
    histogram bin whose cumulative count reaches ratio * its total (inf
    for a class with no pixel)."""
    num_classes, nbins = class_hist.shape
    bin_edges = np.linspace(0.0, ent_max, nbins + 1)
    cum = np.cumsum(class_hist, axis=1)
    totals = cum[:, -1]
    out = {}
    for ratio in RATIOS:
        per_class = np.full((num_classes,), np.inf, np.float32)
        for c in range(num_classes):
            if totals[c] > 0:
                k = int(np.searchsorted(cum[c], ratio * totals[c], 'left'))
                per_class[c] = bin_edges[min(k + 1, nbins)]
        out[ratio] = per_class
    return out


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def _to_hwc16(t: torch.Tensor) -> np.ndarray:
    return t[0].permute(1, 2, 0).to(torch.float16).contiguous().cpu().numpy()


def generate_pseudo_labels(cfg: Union[str, Config], checkpoint: str,
                           out_dir: str, split: str = 'val',
                           save_feats: bool = False,
                           feat_levels: Iterable[int] = (3,),
                           mean_sim: Iterable[float] = (0.6,),
                           kernel_size: int = 3, dilation: int = 2,
                           device: Union[str, torch.device] = 'cuda'
                           ) -> dict:
    """Write the corpus of ``cfg.data[split]`` (in test mode) labelled by
    the student of ``checkpoint`` into ``out_dir``. Runs on ``device``
    (the card unless the CPU is asked for). Returns the image names, the
    thresholds, the sigmas and the seconds spent, per image, in each part:
    ``infer`` (the model), ``entropy`` (the histograms), ``write`` (the
    first files), ``sim`` (reading the features back and their similarity
    maps) and ``rewrite`` (the final files)."""
    if isinstance(cfg, str):
        cfg = Config.fromfile(cfg)
    logger = get_root_logger()
    feat_levels, mean_sim = list(feat_levels), list(mean_sim)
    os.makedirs(out_dir, exist_ok=True)
    dataset = build_dataset({**cfg.data[split], 'test_mode': True})
    model = init_segmentor(cfg, checkpoint, device=device)
    device = next(model.parameters()).device
    num_classes = model.num_classes
    ent_max = float(np.log(num_classes)) + 1e-6
    class_hist = torch.zeros(num_classes * NBINS, dtype=torch.int64,
                             device=device)
    names: List[str] = []
    sample_feats: List[torch.Tensor] = []
    times: Dict[str, List[float]] = {k: [] for k in (
        'infer', 'entropy', 'write', 'sim', 'rewrite')}
    n = len(dataset)
    for idx in range(n):
        sample = dataset[idx]
        imgs, metas = sample['img'], sample['img_metas']
        img = imgs[0] if isinstance(imgs, list) else imgs
        meta = metas[0] if isinstance(metas, list) else metas
        t0 = time.perf_counter()
        with torch.inference_mode():
            view = normalize_views([img], [meta], device)[0]
            logits, states = model.encode_decode(view)
            _sync(device)
            t1 = time.perf_counter()
            ent, label = entropy_and_label(logits[0])
            bins = torch.clamp((ent / ent_max * NBINS).long(), max=NBINS - 1)
            class_hist += torch.bincount(
                (label * NBINS + bins).reshape(-1),
                minlength=num_classes * NBINS)
            _sync(device)
            t2 = time.perf_counter()
            arrays = {'seg_logits': logits[0].to(torch.float16).cpu()
                      .numpy()}
            if save_feats:
                for lvl in feat_levels:
                    arrays[f'feats_{lvl}'] = _to_hwc16(states['feats'][lvl])
            if idx < SIGMA_SAMPLES:
                sample_feats.append(states['decoded_features'].float()
                                    .clone())
        name = osp.splitext(osp.basename(meta['filename']))[0]
        names.append(name)
        write_h5(osp.join(out_dir, f'{name}.h5'), arrays)
        t3 = time.perf_counter()
        for key, dt in (('infer', t1 - t0), ('entropy', t2 - t1),
                        ('write', t3 - t2)):
            times[key].append(dt)
        if (idx + 1) % 50 == 0:
            print_log(f'{idx + 1}/{n} images dumped', logger)

    thresholds = thresholds_from_histograms(
        class_hist.reshape(num_classes, NBINS).cpu().numpy(), ent_max)
    with torch.inference_mode():
        sigmas = {str(ms): solve_sigma(sample_feats, kernel_size, dilation,
                                       ms) for ms in mean_sim}
    del sample_feats
    with open(osp.join(out_dir, 'sigmas.json'), 'w') as f:
        json.dump(sigmas, f, indent=2)

    sigma0 = sigmas[str(mean_sim[0])]
    for name in names:
        path = osp.join(out_dir, f'{name}.h5')
        t0 = time.perf_counter()
        arrays = read_h5(path)
        arrays.update({f'thre@{ratio}': th
                       for ratio, th in thresholds.items()})
        if save_feats:
            for lvl in feat_levels:
                feat = arrays.get(f'feats_{lvl}')
                if feat is None:
                    continue
                # float16 crosses to the device and widens there (exactly)
                x = torch.from_numpy(feat).to(device).float() \
                    .permute(2, 0, 1)[None].contiguous()
                with torch.inference_mode():
                    sim = neighborhood_similarity(x, kernel_size, dilation,
                                                  'gaussian', sigma0)
                arrays[f'gaussian_sim_feat_{lvl}'] = _to_hwc16(sim)
        t1 = time.perf_counter()
        write_h5(path, arrays)
        times['sim'].append(t1 - t0)
        times['rewrite'].append(time.perf_counter() - t1)
    print_log(f'thresholds + sigmas written to {out_dir}', logger)
    return dict(names=names, thresholds=thresholds, sigmas=sigmas,
                num_classes=num_classes, times=times)


def main(args: Optional[list] = None) -> dict:
    """The command line of ``tools/gen_pseudo_labels_torch.py``."""
    import argparse

    from ..utils import DictAction
    p = argparse.ArgumentParser(description='Write a pseudo-label corpus')
    p.add_argument('config')
    p.add_argument('checkpoint')
    p.add_argument('--out-dir', required=True)
    p.add_argument('--split', default='val',
                   choices=['train', 'val', 'test'])
    p.add_argument('--save-feats', action='store_true')
    p.add_argument('--feat-levels', type=int, nargs='+', default=[3])
    p.add_argument('--mean-sim', type=float, nargs='+', default=[0.6])
    p.add_argument('--kernel-size', type=int, default=3)
    p.add_argument('--dilation', type=int, default=2)
    p.add_argument('--cfg-options', nargs='+', action=DictAction)
    p.add_argument('--device', default='cuda',
                   help='torch device (default: the card)')
    a = p.parse_args(args)
    cfg = Config.fromfile(a.config)
    if a.cfg_options:
        cfg.merge_from_dict(a.cfg_options)
    return generate_pseudo_labels(
        cfg, a.checkpoint, a.out_dir, split=a.split,
        save_feats=a.save_feats, feat_levels=a.feat_levels,
        mean_sim=a.mean_sim, kernel_size=a.kernel_size,
        dilation=a.dilation, device=a.device)
