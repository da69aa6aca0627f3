"""Evaluation API (port of ``pfst_tpu/apis/test.py``; mirrors
``rsiseg/apis/test.py:36-287``).

``make_inference_fn`` gives pre-softmax logits at input size,
``_finalize_views`` turns a request's views into its label map,
``make_state_fn`` extracts the feature state (neighborhood similarity of
the decoded features, reference ``apis/test.py:160-191``) and
``single_gpu_test`` runs a dataset through them, whole image by whole
image, into ``pre_eval`` histograms or label maps. Images are NCHW tensors
on the model's device; with ``quant_int8`` the forward runs under
``ops.quant.int8_inference``. The multi-device test waits for ROADMAP
A14b and spatially sharded inference for A14c.
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, List, Optional

import numpy as np
import torch

from ..ops import neighborhood_similarity, resize
from ..ops.quant import int8_inference
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
    the JAX function traces it (``test.py:130-148``)."""
    if spatial:
        raise NotImplementedError('spatially sharded inference is not '
                                  'ported (ROADMAP A14c)')
    qctx = int8_inference(act_scales=act_scales) if quant_int8 \
        else contextlib.nullcontext()
    with qctx:
        return _single_gpu_test_body(model, data_loader, pre_eval,
                                     progress, return_states,
                                     state_proc_cfg)


def _single_gpu_test_body(model, data_loader, pre_eval, progress,
                          return_states, state_proc_cfg):
    dataset = data_loader.dataset
    device = next(model.parameters()).device
    infer = make_inference_fn(model)
    state_fn = make_state_fn(model, state_proc_cfg) if return_states \
        else None
    state_list: List[Any] = []
    results: List[Any] = []
    logger = get_root_logger()
    t0 = time.time()
    n = len(dataset)

    def fetch(idx):
        sample = dataset[idx]
        imgs, metas = sample['img'], sample['img_metas']
        if not isinstance(imgs, list):
            imgs, metas = [imgs], [metas]
        return normalize_views(imgs, metas, device), metas

    nxt = fetch(0) if n else None
    for idx in range(n):
        views, metas = nxt
        view_logits = [infer(v) for v in views]
        if idx + 1 < n:
            nxt = fetch(idx + 1)
        pred = _finalize_views(model, view_logits, metas,
                               metas[0]['ori_shape'][:2])
        if state_fn is not None:
            st = state_fn(views[0])
            state_list.append({k: v[0].float().cpu().numpy()
                               for k, v in st.items()})
        if pre_eval:
            results.extend(dataset.pre_eval(pred, idx))
        else:
            results.append(pred)
        if progress and (idx + 1) % 50 == 0:
            rate = (idx + 1) / (time.time() - t0)
            print_log(f'eval {idx + 1}/{n} ({rate:.1f} img/s)', logger)
    if return_states:
        return results, state_list
    return results
