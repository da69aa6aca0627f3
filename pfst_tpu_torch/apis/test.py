"""Evaluation API (port of ``pfst_tpu/apis/test.py``; mirrors
``rsiseg/apis/test.py:36-287``).

``make_inference_fn`` gives pre-softmax logits at input size,
``_finalize_views`` turns a request's views into its label map,
``make_state_fn`` extracts the feature state (neighborhood similarity of
the decoded features, reference ``apis/test.py:160-191``) and
``single_gpu_test`` runs a dataset through them, whole image by whole
image, into ``pre_eval`` histograms or label maps; ``multi_gpu_test``
spreads the images over the ranks of a process group and gives every
rank ``single_gpu_test``'s results. Images are NCHW tensors on the
model's device; with ``quant_int8`` the forward runs under
``ops.quant.int8_inference``. ``single_gpu_test(spatial=n)`` shards each
whole-image forward's height over the n ranks of the process group
(``parallel/spatial.py``).
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..ops import neighborhood_similarity, resize
from ..ops.quant import int8_inference
from ..parallel.mesh import default_group
from ..utils.logger import get_root_logger, print_log


def make_inference_fn(model):
    """img (NCHW) -> pre-softmax logits (NCHW) at input size. View
    finalization rescales the LOGITS to the original shape and softmaxes
    after, the reference's TTA order (``encoder_decoder.py:284-310``)."""

    @torch.inference_mode()
    def infer(img):
        logits, _ = model.inference_logits(img)
        return logits

    return infer


def make_state_fn(model, sim_cfg: Optional[dict] = None):
    """img -> feature state: the decoded features, their neighborhood
    similarity (``sim_cfg`` defaults: k=3, d=2, gaussian, sigma=30) and
    the logits. On the card the similarity runs the CUDA kernel."""
    sim_cfg = sim_cfg or {}

    @torch.inference_mode()
    def states(img):
        _, st = model.encode_decode(img)
        feats = st['decoded_features']
        sim = neighborhood_similarity(
            feats, sim_cfg.get('kernel_size', 3),
            sim_cfg.get('dilation', 2),
            sim_type=sim_cfg.get('sim_type', 'gaussian'),
            sigma=float(sim_cfg.get('sigma', 30.0)))
        return {'decoded_features': feats, 'sim_feat': sim,
                'seg_logits': st['seg_logits']}

    return states


@torch.inference_mode()
def _view_probs(model, view_logits, metas, ori_shape) -> torch.Tensor:
    """Sum over a request's views of the softmax of each view's logits,
    flips undone and rescaled to ``ori_shape``; (1, K, H, W) fp32."""
    acc = None
    for logits, meta in zip(view_logits, metas):
        if meta.get('flip', False):
            dirs = meta.get('flip_direction') or []
            dirs = dirs if isinstance(dirs, list) else [dirs]
            for d in dirs:
                logits = torch.flip(logits,
                                    dims=(3 if d == 'horizontal' else 2,))
        if tuple(logits.shape[2:]) != tuple(ori_shape):
            logits = resize(logits, size=ori_shape, mode='bilinear',
                            align_corners=model.align_corners)
        probs = torch.softmax(logits.float(), dim=1)
        acc = probs if acc is None else acc + probs
    return acc


def _finalize_views(model, view_logits, metas, ori_shape) -> np.ndarray:
    """Undo TTA flips, rescale each view's LOGITS to ``ori_shape``,
    softmax, sum and argmax, in the order of the JAX file
    (``test.py:97-118``): the label map (H, W) as numpy."""
    acc = _view_probs(model, view_logits, metas, ori_shape)
    return acc.argmax(dim=1)[0].cpu().numpy()


def normalize_views(imgs, metas, device) -> List[torch.Tensor]:
    """A sample's CHW numpy views as (1, C, H, W) tensors on ``device``.
    A view its pipeline left on the 0-255 scale (``DeferNormalize``: uint8
    or float16) is normalized there with the mean and std its metas
    record; float32 views were normalized on the host."""
    out = []
    for img, meta in zip(imgs, metas):
        t = torch.from_numpy(np.ascontiguousarray(img))[None].to(device)
        if t.dtype in (torch.uint8, torch.float16):
            norm = meta['img_norm_cfg']
            mean = torch.as_tensor(np.asarray(norm['mean']), device=device)
            std = torch.as_tensor(np.asarray(norm['std']), device=device)
            t = (t.float() - mean.float().view(1, -1, 1, 1)) / \
                std.float().view(1, -1, 1, 1)
        out.append(t)
    return out


def single_gpu_test(model,
                    data_loader,
                    pre_eval: bool = True,
                    format_only: bool = False,
                    out_dir: Optional[str] = None,
                    progress: bool = True,
                    return_states: bool = False,
                    state_proc_cfg: Optional[dict] = None,
                    quant_int8: bool = False,
                    act_scales: Optional[dict] = None,
                    spatial: int = 0):
    """Every image of ``data_loader.dataset`` through ``model`` (in eval
    mode, on its device), whole: ``pre_eval`` tuples, or label maps, and
    with ``return_states`` also each image's feature state as numpy
    (``test.py:121-236``). The next image's host pipeline runs while the
    card computes the current one. ``format_only`` and ``out_dir`` are
    accepted and unused, as in the JAX function: the caller writes label
    maps out with the dataset's ``format_results``, and nothing draws
    overlays. ``quant_int8``: every conv and Dense of the JAX layer set
    runs int8 (``ops.quant.int8_inference``) with ``act_scales`` (a
    ``{module_path: max|x|}`` table, or dynamic scales without one), as
    the JAX function traces it (``test.py:130-148``).

    ``spatial=n``: every rank of the default group (n ranks) runs this,
    reads every image and computes its stripe of each whole-image forward
    (``parallel.spatial.make_spatial_inference_fn``: the height sharded,
    edge-padded to a multiple of n); rank 0 assembles the logits, finalizes
    the views and returns the results, the other ranks None."""
    dataset = data_loader.dataset
    if spatial and (return_states or quant_int8):
        raise NotImplementedError('spatial inference with the feature '
                                  'states or int8')
    with _int8(quant_int8, act_scales):
        per_image, states = _test_images(
            model, dataset, range(len(dataset)), pre_eval, progress,
            return_states, state_proc_cfg, spatial)
    if spatial and dist.get_rank(default_group()) != 0:
        return None
    results = [r for chunk in per_image for r in chunk]
    if return_states:
        return results, states
    return results


def _int8(quant_int8: bool, act_scales):
    return int8_inference(act_scales=act_scales) if quant_int8 \
        else contextlib.nullcontext()


def multi_gpu_test(model,
                   data_loader,
                   pre_eval: bool = True,
                   format_only: bool = False,
                   out_dir: Optional[str] = None,
                   progress: bool = True,
                   return_states: bool = False,
                   state_proc_cfg: Optional[dict] = None,
                   quant_int8: bool = False,
                   act_scales: Optional[dict] = None):
    """``single_gpu_test`` spread over the ranks of the default process
    group (the reference's ``multi_gpu_test``, ``apis/test.py:194-287``,
    and the JAX one, ``test.py:237-423``): rank r scores images
    ``r::world`` of the dataset, and the per-image ``pre_eval`` tuples, or
    label maps, are gathered back into dataset order on every rank with
    ``all_gather_object`` (host objects, so it runs on gloo beside CUDA
    tensors too). The results are ``single_gpu_test``'s, image for image.
    ``quant_int8`` and ``act_scales`` are as there; ``return_states``
    (a single-device diagnostic), one process and a group of one rank
    run ``single_gpu_test``."""
    group = default_group()
    world = dist.get_world_size(group) if group is not None else 1
    if return_states or world == 1:
        return single_gpu_test(model, data_loader, pre_eval=pre_eval,
                               format_only=format_only, out_dir=out_dir,
                               progress=progress,
                               return_states=return_states,
                               state_proc_cfg=state_proc_cfg,
                               quant_int8=quant_int8, act_scales=act_scales)
    dataset = data_loader.dataset
    n = len(dataset)
    rank = dist.get_rank(group)
    with _int8(quant_int8, act_scales):
        mine, _ = _test_images(model, dataset, range(rank, n, world),
                               pre_eval, progress, False, None)
    shares: List[Any] = [None] * world
    dist.all_gather_object(shares, mine, group=group)
    return [r for i in range(n) for r in shares[i % world][i // world]]


def _test_images(model, dataset, indices, pre_eval, progress,
                 return_states, state_proc_cfg, spatial: int = 0):
    """Images ``indices`` of ``dataset`` through ``model``: a list of each
    image's results (its ``pre_eval`` tuples, or ``[label map]``), and
    with ``return_states`` the images' feature states."""
    device = next(model.parameters()).device
    if spatial:
        from ..parallel.spatial import make_spatial_inference_fn
        infer = make_spatial_inference_fn(model, spatial)
    else:
        infer = make_inference_fn(model)
    state_fn = make_state_fn(model, state_proc_cfg) if return_states \
        else None
    state_list: List[Any] = []
    results: List[Any] = []
    logger = get_root_logger()
    t0 = time.time()
    indices = list(indices)
    n = len(indices)

    def fetch(idx):
        sample = dataset[idx]
        imgs, metas = sample['img'], sample['img_metas']
        if not isinstance(imgs, list):
            imgs, metas = [imgs], [metas]
        return normalize_views(imgs, metas, device), metas

    nxt = fetch(indices[0]) if n else None
    for pos, idx in enumerate(indices):
        views, metas = nxt
        view_logits = [infer(v) for v in views]
        if pos + 1 < n:
            nxt = fetch(indices[pos + 1])
        if view_logits[0] is None:
            continue   # a spatial rank other than the first
        pred = _finalize_views(model, view_logits, metas,
                               metas[0]['ori_shape'][:2])
        if state_fn is not None:
            st = state_fn(views[0])
            state_list.append({k: v[0].float().cpu().numpy()
                               for k, v in st.items()})
        results.append(list(dataset.pre_eval(pred, idx)) if pre_eval
                       else [pred])
        if progress and (pos + 1) % 50 == 0:
            rate = (pos + 1) / (time.time() - t0)
            print_log(f'eval {pos + 1}/{n} ({rate:.1f} img/s)', logger)
    return results, state_list
