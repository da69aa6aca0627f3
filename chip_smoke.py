#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``pfst_tpu_torch``) on one
NVIDIA Hopper card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result lines):

1. the card: CUDA present, compute capability 9.0, name and power limit;
2. build the CUDA kernels from ``pfst_tpu_torch/ops/csrc`` (nvcc, sm_90a,
   cached under ``build/pfst_tpu_torch/``);
3. each kernel against its plain PyTorch version at the path's shapes,
   with its median time, the plain version's and the memory/compute bound;
4. the serving path at full width: the Pots->Vaih DeepLabV3+ R50-D8 leaf
   config with seeded random weights answers 1024x1024 requests
   (``make_inference_fn`` -> ``_finalize_views`` -> labels, then
   ``make_state_fn`` -> ``sim_feat`` through the kernel), with the kernel
   launch counts read around this phase only;
5. card against CPU on one 512x512 image with TF32 off;
6. informational: fused inference + pseudo-labels at batch 24, 512x512, in
   fp32 and bf16 autocast;
7. one ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}`` line.

Imports nothing of JAX and nothing of the JAX package.
"""
import copy
import json
import os.path as osp
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

from pfst_tpu_torch.apis import (_finalize_views, init_segmentor,
                                 make_inference_fn, make_state_fn)
from pfst_tpu_torch.ops import (build, cuda_neighborhood_similarity,
                                torch_neighborhood_similarity)
from pfst_tpu_torch.utils import Config

ROOT = osp.dirname(osp.abspath(__file__))
LEAF = osp.join(ROOT, 'configs', 'pfst',
                'pfst_pots_irrg2vaih_irrg_deeplabv3plus_r50-d8.py')
# NVIDIA H100 SXM data sheet: HBM3 rate and fp32 (non-tensor-core) peak
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
SIM_TOL = 1e-5
SIM_K, SIM_D, SIGMA = 3, 2, 30.0
# (shape, sim_type): serving (1024^2 request, make_state_fn) and the
# PFGST training loss (2 x 512^2 crops, pfgst_loss.py:95-109)
SIM_CASES = [((1, 512, 128, 128), 'gaussian'), ((2, 512, 64, 64), 'cosine')]
N_REQUESTS = 6
REQUEST_HW = (1024, 1024)
BATCH, PATCH, THRESHOLD = 24, 512, 0.98


def log(msg):
    print(msg, flush=True)


def cuda_time_ms(fn, reps):
    """Median of ``reps`` launches, each timed with its own CUDA events,
    after two warm-up calls."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_card():
    if not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: this smoke test runs on the card')
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise RuntimeError(f'needs a Hopper card (sm_90), got sm_{cap}')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f'torch {torch.__version__} cuda {torch.version.cuda} '
        f'device_count {torch.cuda.device_count()}')
    return card


def phase_build():
    t0 = time.time()
    path = build.build('neighborhood_sim')
    build.load('neighborhood_sim')
    log(f'[build] {osp.relpath(path, ROOT)} in {time.time() - t0:.1f} s')


def sim_bound(shape, dtype, sim_type):
    """Least time on the card: each input byte read once and each output
    byte written once over the HBM rate, against the fp32 operations
    (cosine: dot and |n|^2, 2 FMAs per neighbor-channel, plus |c|^2;
    gaussian: a subtract and an FMA) over the fp32 peak."""
    b, c, h, w = shape
    k2 = SIM_K * SIM_K
    nbytes = b * c * h * w * torch.finfo(dtype).bits // 8 + b * k2 * h * w * 4
    per_px = k2 * c * 4 + 2 * c if sim_type == 'cosine' else k2 * c * 3
    flops = b * h * w * per_px
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, 'bytes' if t_bytes >= t_ops \
        else 'operations'


def phase_kernel_vs_plain():
    gen = torch.Generator().manual_seed(0)
    cases = []
    for shape, sim_type in SIM_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(shape, generator=gen).to('cuda', dtype)
            out = cuda_neighborhood_similarity(x, SIM_K, SIM_D, sim_type,
                                               SIGMA)
            ref = torch_neighborhood_similarity(x, SIM_K, SIM_D, sim_type,
                                                SIGMA)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            ms = cuda_time_ms(lambda: cuda_neighborhood_similarity(
                x, SIM_K, SIM_D, sim_type, SIGMA), 30)
            plain_ms = cuda_time_ms(lambda: torch_neighborhood_similarity(
                x, SIM_K, SIM_D, sim_type, SIGMA), 20)
            bound_ms, bound_by = sim_bound(shape, dtype, sim_type)
            case = dict(shape=list(shape), dtype=str(dtype).split('.')[-1],
                        sim_type=sim_type, max_abs_err=err, ms=ms,
                        plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by=bound_by)
            log(f'[kernel] neighborhood_sim {case}')
            if not err <= SIM_TOL:
                raise AssertionError(f'kernel disagrees with its plain '
                                     f'version by {err} > {SIM_TOL}')
            cases.append(case)
    return cases


def _request(cfg, seed, hw):
    """A normalized request image (the test pipeline's Normalize on a
    seeded random uint8 image), NCHW on the card."""
    norm = cfg.img_norm_cfg
    img = np.random.RandomState(seed).randint(0, 256, (*hw, 3), np.uint8)
    img = img.astype(np.float32)
    if norm.get('to_rgb'):
        img = img[..., ::-1]
    img = (img - np.asarray(norm['mean'], np.float32)) / \
        np.asarray(norm['std'], np.float32)
    return torch.from_numpy(np.ascontiguousarray(
        img.transpose(2, 0, 1)[None]))


def phase_serving(cfg, model):
    infer = make_inference_fn(model)
    state_fn = make_state_fn(model)     # sim_cfg defaults: k3 d2 gaussian
    num_classes = model.num_classes
    imgs = [_request(cfg, seed, REQUEST_HW) for seed in range(N_REQUESTS)]
    torch.cuda.synchronize()
    cuda_neighborhood_similarity.launches = 0
    times = []
    for i, img in enumerate(imgs):
        t0 = time.time()
        img = img.cuda()
        logits = infer(img)
        labels = _finalize_views(model, [logits], [{'flip': False}],
                                 REQUEST_HW)
        states = state_fn(img)
        sim = states['sim_feat'].cpu()
        torch.cuda.synchronize()
        times.append((time.time() - t0) * 1e3)
        if labels.shape != REQUEST_HW or not (
                0 <= labels.min() and labels.max() < num_classes):
            raise AssertionError(f'request {i}: bad labels {labels.shape} '
                                 f'{labels.min()}..{labels.max()}')
        h, w = REQUEST_HW[0] // 8, REQUEST_HW[1] // 8
        if tuple(sim.shape) != (1, SIM_K**2, h, w) or \
                not torch.isfinite(sim).all() or \
                not (0 <= float(sim.min()) and float(sim.max()) <= 1):
            raise AssertionError(f'request {i}: bad sim_feat {sim.shape}')
        if not torch.isfinite(logits).all():
            raise AssertionError(f'request {i}: non-finite logits')
    launches = cuda_neighborhood_similarity.launches
    log(f'[serve] {N_REQUESTS} requests of {REQUEST_HW}: ms per request '
        f'{[round(t, 1) for t in times]}, kernel launches {launches}, '
        f'last sim_feat mean {float(sim.mean()):.6f}')
    if launches < 1:
        raise AssertionError('the serving path never launched the kernel')
    return launches, times


def phase_card_vs_cpu(cfg, model):
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cpu_model = copy.deepcopy(model).cpu()
        img = _request(cfg, 100, (PATCH, PATCH))
        card_logits = make_inference_fn(model)(img.cuda()).cpu()
        cpu_logits = make_inference_fn(cpu_model)(img)
        # the serving default (gaussian, sigma 30) and cosine, which does
        # not saturate on the large features of random weights
        sims = {}
        for sim_type in ('gaussian', 'cosine'):
            sim_cfg = dict(sim_type=sim_type)
            sims[sim_type] = (
                make_state_fn(model, sim_cfg)(img.cuda())['sim_feat'].cpu(),
                make_state_fn(cpu_model, sim_cfg)(img)['sim_feat'])
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old
    scale = float(cpu_logits.abs().max())
    logit_err = float((card_logits - cpu_logits).abs().max())
    agree = float((card_logits.argmax(1) == cpu_logits.argmax(1))
                  .float().mean())
    sim_err = max(float((card - cpu).abs().max())
                  for card, cpu in sims.values())
    sim_mean = {k: round(float(cpu.abs().mean()), 6)
                for k, (_, cpu) in sims.items()}
    log(f'[card-vs-cpu] 512x512: logit err {logit_err:.3e} '
        f'(limit {1e-3 * scale:.3e}), argmax agreement {agree:.6f}, '
        f'sim_feat err {sim_err:.3e} (mean |sim| {sim_mean})')
    if not (logit_err <= 1e-3 * scale and agree >= 0.999
            and sim_err <= 1e-4):
        raise AssertionError('card and CPU disagree')


def phase_pseudo_label(cfg, model, card):
    """Informational: the fused inference + pseudo-label pass of
    ``bench.py:50-61`` at batch 24, 512x512."""
    bf16_cfg = cfg.copy()
    bf16_cfg.model['dtype'] = 'bfloat16'
    bf16_model = init_segmentor(bf16_cfg)
    bf16_model.load_state_dict(model.state_dict())
    gen = torch.Generator().manual_seed(1)
    img = torch.randn((BATCH, 3, PATCH, PATCH), generator=gen).cuda()

    @torch.inference_mode()
    def fused(m):
        logits, _ = m.encode_decode(img)
        probs = torch.softmax(logits.float(), dim=1)
        pseudo_prob, pseudo_label = probs.max(dim=1)
        quality = (pseudo_prob >= THRESHOLD).float().mean()
        return pseudo_label, pseudo_prob, quality

    for name, m in (('fp32', model), ('bf16', bf16_model)):
        for _ in range(2):
            fused(m)
        torch.cuda.synchronize()
        steps, t0 = 5, time.time()
        for _ in range(steps):
            fused(m)
        torch.cuda.synchronize()
        rate = steps * BATCH / (time.time() - t0)
        log(f'[pseudo-label] {name} batch {BATCH} {PATCH}^2: '
            f'{rate:.2f} patches/s on {card}')


def main():
    card = phase_card()
    phase_build()
    cases = phase_kernel_vs_plain()
    cfg = Config.fromfile(LEAF)
    model = init_segmentor(cfg)      # seeded random weights, on the card
    launches, _ = phase_serving(cfg, model)
    phase_card_vs_cpu(cfg, model)
    phase_pseudo_label(cfg, model, card)
    main_case = next(c for c in cases if c['shape'] == list(SIM_CASES[0][0])
                     and c['dtype'] == 'float32')
    kernels = [dict(
        name='neighborhood_similarity', route='cuda',
        source='pfst_tpu_torch/ops/csrc/neighborhood_sim.cu',
        replaces='pfst_tpu/ops/pallas_sim.py:35',
        launches=launches,
        max_abs_err=max(c['max_abs_err'] for c in cases),
        ms=main_case['ms'], plain_ms=main_case['plain_ms'],
        bound_ms=main_case['bound_ms'], bound_by=main_case['bound_by'],
        library_ms=None, cases=cases)]
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    try:
        main()
    except Exception:  # noqa: BLE001 - report the failed phase, exit 1
        traceback.print_exc()
        sys.exit(1)
