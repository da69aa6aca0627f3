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
3b. the similarity's backward kernel against autograd of the plain
   forward and against the plain gather backward, at the training shape
   (2, 512, 64, 64), both similarity types, fp32 and bf16 input;
4. the serving path at full width: the Pots->Vaih DeepLabV3+ R50-D8 leaf
   config with seeded random weights answers 1024x1024 requests
   (``make_inference_fn`` -> ``_finalize_views`` -> labels, then
   ``make_state_fn`` -> ``sim_feat`` through the kernel), with the kernel
   launch counts read around this phase only;
5. card against CPU on one 512x512 image with TF32 off;
6. informational: fused inference + pseudo-labels at batch 24, 512x512, in
   fp32 and bf16 autocast;
7. training at full width: ``build_train_model`` -> ``PFGST.init_state``
   -> ``make_train_step``, AdamW from the config, steps on seeded
   synthetic batches of 2 x 512x512 crops, in fp32 (TF32 convolutions, the
   default) and in bf16 autocast, with the kernels' launches per step read
   around each run, the EMA teacher checked, and s/iter;
8. one training step card against CPU, 2 x 128x128 crops, full width and
   depth, dropout off, TF32 off: log vars and student gradients;
then one ``{"kernels": [...]}`` line and the ``{"ok": true, ...}`` line.

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
from pfst_tpu_torch.core import build_optimizer
from pfst_tpu_torch.models import build_train_model
from pfst_tpu_torch.ops import (build, cuda_neighborhood_similarity,
                                cuda_neighborhood_similarity_backward,
                                torch_neighborhood_similarity,
                                torch_neighborhood_similarity_backward)
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
# the PFGST loss's similarity at the leaf config: 2 x 512^2 crops give
# decoded features (2, 512, 64, 64), cosine, k3 d2 (pfgst_loss.py:183-184)
BWD_SHAPE = (2, 512, 64, 64)
TRAIN_HW, TRAIN_STEPS, TRAIN_WARMUP = (512, 512), 8, 3
CHECK_HW = (128, 128)
# the last BN scale of each residual block in the card-against-CPU step
RESIDUAL_SCALE = 0.25


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
    byte written once (for cosine the per-pixel norms too, which the
    training path saves) over the HBM rate, against the fp32 operations
    (cosine: dot and |n|^2, 2 FMAs per neighbor-channel, plus |c|^2;
    gaussian: a subtract and an FMA) over the fp32 peak."""
    b, c, h, w = shape
    k2 = SIM_K * SIM_K
    nbytes = b * c * h * w * torch.finfo(dtype).bits // 8 + b * k2 * h * w * 4
    if sim_type == 'cosine':
        nbytes += b * h * w * 4
    per_px = k2 * c * 4 + 2 * c if sim_type == 'cosine' else k2 * c * 3
    flops = b * h * w * per_px
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, 'bytes' if t_bytes >= t_ops \
        else 'operations'


def phase_kernel_vs_plain():
    """Each forward case as its path calls it: the cosine (training) case
    also saves the per-pixel norms, checked against ``x.norm`` to the
    same relative limit."""
    gen = torch.Generator().manual_seed(0)
    cases = []
    for shape, sim_type in SIM_CASES:
        cosine = sim_type == 'cosine'
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(shape, generator=gen).to('cuda', dtype)

            def kernel():
                return cuda_neighborhood_similarity(
                    x, SIM_K, SIM_D, sim_type, SIGMA, with_norms=cosine)
            out = kernel()
            ref = torch_neighborhood_similarity(x, SIM_K, SIM_D, sim_type,
                                                SIGMA)
            if cosine:
                out, norms = out
                norm_ref = x.float().norm(dim=1)
                norm_err = float(((norms - norm_ref).abs()
                                  / norm_ref.clamp(min=1.0)).max())
            else:
                norm_err = 0.0
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            ms = cuda_time_ms(kernel, 30)
            plain_ms = cuda_time_ms(lambda: torch_neighborhood_similarity(
                x, SIM_K, SIM_D, sim_type, SIGMA), 20)
            bound_ms, bound_by = sim_bound(shape, dtype, sim_type)
            case = dict(shape=list(shape), dtype=str(dtype).split('.')[-1],
                        sim_type=sim_type, max_abs_err=err,
                        norm_rel_err=norm_err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bound_ms, bound_by=bound_by)
            log(f'[kernel] neighborhood_sim {case}')
            if not (err <= SIM_TOL and norm_err <= SIM_TOL):
                raise AssertionError(f'kernel disagrees with its plain '
                                     f'version: {case}')
            cases.append(case)
    return cases


def sim_bwd_bound(shape, dtype, sim_type):
    """Least time of the backward: x read and grad_x written in x's type,
    sim and dL/dsim (and the cosine norms) read in fp32, over the HBM
    rate, against the fp32 operations of the gather (k*k FMAs, 2 k*k
    flops, per input element) over the fp32 peak."""
    b, c, h, w = shape
    k2 = SIM_K * SIM_K
    nbytes = 2 * b * c * h * w * torch.finfo(dtype).bits // 8 + \
        2 * b * k2 * h * w * 4
    if sim_type == 'cosine':
        nbytes += b * h * w * 4
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = b * h * w * 2 * k2 * c / FP32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, 'bytes' if t_bytes >= t_ops \
        else 'operations'


def phase_backward_vs_plain():
    """The backward kernel, as the training path launches it (grad_x in
    x's type, the cosine norms from the forward kernel), against autograd
    of the plain forward and the plain gather backward on the same random
    dL/dsim, both in fp32 on the same input values. Limit per element:
    1e-5 * max(1, max|ref|), plus for a bf16 grad_x its rounding,
    2^-8 |ref|. ``max_abs_err`` is the raw max |kernel - autograd|."""
    gen = torch.Generator().manual_seed(2)
    b, _, h, w = BWD_SHAPE
    cases = []
    for sim_type in ('cosine', 'gaussian'):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(BWD_SHAPE, generator=gen).to('cuda', dtype)
            g = torch.randn((b, SIM_K**2, h, w), generator=gen).cuda()
            if sim_type == 'cosine':
                sim, norms = cuda_neighborhood_similarity(
                    x, SIM_K, SIM_D, sim_type, SIGMA, with_norms=True)
            else:
                sim, norms = cuda_neighborhood_similarity(
                    x, SIM_K, SIM_D, sim_type, SIGMA), None
            xf = x.float().requires_grad_()
            sim_ref = torch_neighborhood_similarity(xf, SIM_K, SIM_D,
                                                    sim_type, SIGMA)
            (auto,) = torch.autograd.grad(sim_ref, xf, g, retain_graph=True)
            plain = torch_neighborhood_similarity_backward(
                xf.detach(), sim_ref.detach(), g, SIM_K, SIM_D, sim_type,
                SIGMA)

            def kernel():
                return cuda_neighborhood_similarity_backward(
                    x, sim, g, SIM_K, SIM_D, sim_type, SIGMA, norms=norms)
            out = kernel().float()
            torch.cuda.synchronize()
            limit = 1e-5 * max(1.0, float(auto.abs().max()))
            rounding = 2.0**-8 if dtype == torch.bfloat16 else 0.0
            err = float((out - auto).abs().max())
            excess = max(float(((out - ref).abs() - rounding * ref.abs())
                               .max()) for ref in (auto, plain))
            ms = cuda_time_ms(kernel, 30)
            plain_ms = cuda_time_ms(lambda: torch.autograd.grad(
                sim_ref, xf, g, retain_graph=True), 20)
            gather_ms = cuda_time_ms(
                lambda: torch_neighborhood_similarity_backward(
                    xf.detach(), sim_ref.detach(), g, SIM_K, SIM_D,
                    sim_type, SIGMA), 20)
            bound_ms, bound_by = sim_bwd_bound(BWD_SHAPE, dtype, sim_type)
            case = dict(shape=list(BWD_SHAPE), dtype=str(dtype).split('.')[-1],
                        sim_type=sim_type, max_abs_err=err,
                        err_beyond_rounding=excess, limit=limit, ms=ms,
                        plain_ms=plain_ms, plain_gather_ms=gather_ms,
                        bound_ms=bound_ms, bound_by=bound_by)
            log(f'[kernel] neighborhood_sim backward {case}')
            if not excess <= limit:
                raise AssertionError(f'backward kernel disagrees with the '
                                     f'plain version: {case}')
            cases.append(case)
            del xf, sim_ref, auto, plain
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


def _train_batch(cfg, seed, hw):
    """A synthetic training batch on the card: source, target and strong
    target images (seeded uint8 noise, normalized as the pipeline does)
    and a source label map of 6 classes in 32x32 blocks with a band of 255
    (the ignore label) across the top."""
    rs = np.random.RandomState(seed)
    norm = cfg.img_norm_cfg
    mean = np.asarray(norm['mean'], np.float32).reshape(1, 3, 1, 1)
    std = np.asarray(norm['std'], np.float32).reshape(1, 3, 1, 1)

    def image():
        img = rs.randint(0, 256, (2, 3, *hw)).astype(np.float32)
        return torch.from_numpy((img - mean) / std).cuda()

    cells = rs.randint(0, 6, (2, hw[0] // 32, hw[1] // 32))
    gt = cells.repeat(32, axis=1).repeat(32, axis=2)
    gt[:, :hw[0] // 16] = 255
    return dict(img=image(), gt_semantic_seg=torch.from_numpy(gt).cuda(),
                target_img=image(), target_img_strong_aug=image())


def _train_setup(cfg, device='cuda'):
    algo = build_train_model(cfg, device=device)
    opt_cfg = cfg.get('optimizer_config') or {}
    tx = build_optimizer(cfg.optimizer, cfg.get('lr_config'),
                         cfg.runner['max_iters'], opt_cfg.get('grad_clip'))
    state = algo.init_state(torch.Generator().manual_seed(0), tx)
    norm = cfg.img_norm_cfg
    return algo, state, algo.make_train_step(norm['mean'], norm['std'])


def _train_run(cfg, name, card):
    """TRAIN_STEPS steps at full width; returns (s/iter, launches of the
    forward and the backward kernel in the run)."""
    algo, state, step = _train_setup(cfg)
    gen = torch.Generator().manual_seed(3)
    probe = 'decode_head.conv_seg.weight'
    start = state.student.get_parameter(probe).detach().clone()
    torch.cuda.synchronize()
    cuda_neighborhood_similarity.launches = 0
    cuda_neighborhood_similarity_backward.launches = 0
    times = []
    for i in range(TRAIN_STEPS):
        batch = _train_batch(cfg, 1000 + i, TRAIN_HW)
        if i == 1:
            a = min(1.0 - 1.0 / (state.step + 1.0), algo.alpha)
            teacher0 = state.teacher.get_parameter(probe).detach().clone()
            student0 = state.student.get_parameter(probe).detach().clone()
        torch.cuda.synchronize()
        t0 = time.time()
        state, log_vars = step(state, batch, gen)
        torch.cuda.synchronize()
        times.append(time.time() - t0)
        vals = {k: float(v) for k, v in log_vars.items()}
        if not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f'[train {name}] step {i}: non-finite log '
                                 f'vars {vals}')
        if i == 1:
            want = teacher0 * a + student0 * (1.0 - a)
            got = state.teacher.get_parameter(probe)
            if not torch.allclose(got, want, rtol=1e-6, atol=1e-7):
                raise AssertionError(f'[train {name}] teacher is not the EMA '
                                     f'a={a}: max |diff| '
                                     f'{float((got - want).abs().max())}')
    launches = (cuda_neighborhood_similarity.launches,
                cuda_neighborhood_similarity_backward.launches)
    moved = float((state.student.get_parameter(probe).detach() - start)
                  .abs().max())
    s_iter = statistics.median(times[TRAIN_WARMUP:])
    log(f'[train {name}] {TRAIN_STEPS} steps, batch 2 of {TRAIN_HW}: s/iter '
        f'{[round(t, 4) for t in times]}, median after {TRAIN_WARMUP} '
        f'warm-ups {s_iter:.4f} s on {card}; kernel launches fwd '
        f'{launches[0]} bwd {launches[1]}; student moved {moved:.3e}; '
        f'last log vars {json.dumps({k: round(v, 6) for k, v in vals.items()})}')
    if launches != (2 * TRAIN_STEPS, TRAIN_STEPS):
        raise AssertionError(f'[train {name}] expected {2 * TRAIN_STEPS} '
                             f'forward and {TRAIN_STEPS} backward kernel '
                             f'launches, got {launches}')
    if not moved > 0:
        raise AssertionError(f'[train {name}] the student did not change')
    return s_iter, launches


def phase_train(cfg, card):
    """Training at full width, fp32 (TF32 convolutions, the default) and
    bf16 autocast."""
    results = {}
    for name, dtype in (('fp32', None), ('bf16', 'bfloat16')):
        tcfg = cfg.copy()
        if dtype:
            tcfg.model['dtype'] = dtype
        results[name] = _train_run(tcfg, name, card)
        torch.cuda.empty_cache()
    return results


def _scale_residual(state, scale):
    """The last BN scale of every residual block set to ``scale`` (in the
    student and the teacher). At the JAX package's init (BN scales 1) the
    step's gradients are ill-conditioned in fp32: the CPU with one thread
    and with eight disagrees by more than the check's limits allow. A
    smaller nonzero scale tames that while every branch still gets a
    gradient."""
    with torch.no_grad():
        for m in state.student.modules():
            names = getattr(m, 'norm_names', None) or (
                [m.norm2_name] if hasattr(m, 'norm2_name') else [])
            if names:
                getattr(m, names[-1]).weight.fill_(scale)
        state.teacher.load_state_dict(state.student.state_dict())


def _grad_groups(state):
    """The student's gradients (left on the parameters by the step) in
    fp64 on the CPU, by group: the stem, each ResNet stage, each head."""
    groups = {}
    for name, p in state.student.named_parameters():
        if p.requires_grad:
            parts = name.split('.')
            key = '.'.join(parts[:2]) if parts[0] == 'backbone' else parts[0]
            groups.setdefault(key, []).append(p.grad.double().cpu())
    return groups


def _cos_and_gap(a, b):
    cos = float(a @ b / (a.norm() * b.norm()))
    return cos, float(abs(a.norm() - b.norm()) / b.norm())


def phase_train_card_vs_cpu(cfg):
    """One step on the card and on the CPU from the same weights (the last
    BN scale of each residual block at ``RESIDUAL_SCALE``), batch and
    draws, dropout off, TF32 off: log vars within rtol 1e-3 (atol 1e-5);
    the student's gradients with cosine similarity >= 0.9999 and norms
    within 1e-3, over all parameters; every parameter tensor gets a
    nonzero gradient. Printed beside them: cosine and norm gap per group,
    and the same two readings for the CPU step with one thread against
    the CPU step with all of them, the step's own fp32 conditioning."""
    tcfg = cfg.copy()
    tcfg.model['decode_head']['dropout_ratio'] = 0.0
    tcfg.model['auxiliary_head']['dropout_ratio'] = 0.0
    batch = {k: v.cpu() for k, v in _train_batch(cfg, 7, CHECK_HW).items()}
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    threads = torch.get_num_threads()
    sides = {}
    try:
        for side, device, n in (('card', 'cuda', threads),
                                ('cpu', 'cpu', threads), ('cpu1', 'cpu', 1)):
            torch.set_num_threads(n)
            _, state, step = _train_setup(tcfg, device)
            _scale_residual(state, RESIDUAL_SCALE)
            _, log_vars = step(state, {k: v.to(device)
                                       for k, v in batch.items()},
                               torch.Generator().manual_seed(5))
            sides[side] = ({k: float(v) for k, v in log_vars.items()},
                           _grad_groups(state))
    finally:
        torch.set_num_threads(threads)
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old
    (card_lv, card_g), (cpu_lv, cpu_g) = sides['card'], sides['cpu']
    cpu1_g = sides['cpu1'][1]
    bad = {k: (card_lv[k], cpu_lv[k]) for k in cpu_lv
           if not abs(card_lv[k] - cpu_lv[k]) <= 1e-5 + 1e-3 * abs(cpu_lv[k])}
    zero = sum(int(not g.any()) for side in (card_g, cpu_g)
               for gs in side.values() for g in gs)
    per_group = {k: [round(v, 8) for v in _cos_and_gap(
        torch.cat([g.flatten() for g in card_g[k]]),
        torch.cat([g.flatten() for g in cpu_g[k]]))] for k in cpu_g}
    flat = {k: torch.cat([g.flatten() for gs in side.values() for g in gs])
            for k, side in (('card', card_g), ('cpu', cpu_g),
                            ('cpu1', cpu1_g))}
    cos, norm_rel = _cos_and_gap(flat['card'], flat['cpu'])
    self_cos, self_gap = _cos_and_gap(flat['cpu1'], flat['cpu'])
    log(f'[train card-vs-cpu] {CHECK_HW}, residual scale {RESIDUAL_SCALE}: '
        f'log vars {len(cpu_lv)} compared, {len(bad)} outside rtol 1e-3; '
        f'gradient cosine {cos:.8f}, norm rel diff {norm_rel:.3e}; '
        f'parameter tensors with a zero gradient {zero}; per group '
        f'[cosine, norm gap] {json.dumps(per_group)}; loss card '
        f'{card_lv["loss"]:.6f} cpu {cpu_lv["loss"]:.6f}; CPU 1 thread '
        f'against {threads}: gradient cosine {self_cos:.8f}, norm rel diff '
        f'{self_gap:.3e}')
    if bad or set(card_lv) != set(cpu_lv) or zero or not (
            cos >= 0.9999 and norm_rel <= 1e-3):
        raise AssertionError(f'card and CPU training disagree: {bad}')


def main():
    card = phase_card()
    phase_build()
    cases = phase_kernel_vs_plain()
    bwd_cases = phase_backward_vs_plain()
    cfg = Config.fromfile(LEAF)
    model = init_segmentor(cfg)      # seeded random weights, on the card
    launches, _ = phase_serving(cfg, model)
    phase_card_vs_cpu(cfg, model)
    phase_pseudo_label(cfg, model, card)
    del model
    torch.cuda.empty_cache()
    train = phase_train(cfg, card)
    phase_train_card_vs_cpu(cfg)
    main_case = next(c for c in cases if c['shape'] == list(SIM_CASES[0][0])
                     and c['dtype'] == 'float32')
    bwd_case = next(c for c in bwd_cases if c['sim_type'] == 'cosine'
                    and c['dtype'] == 'float32')
    train_fwd = sum(t[1][0] for t in train.values())
    train_bwd = sum(t[1][1] for t in train.values())
    kernels = [dict(
        name='neighborhood_similarity', route='cuda',
        source='pfst_tpu_torch/ops/csrc/neighborhood_sim.cu',
        replaces='pfst_tpu/ops/pallas_sim.py:35',
        launches=launches + train_fwd,
        launches_per_request=launches / N_REQUESTS,
        launches_per_train_step=train_fwd / (TRAIN_STEPS * len(train)),
        max_abs_err=max(c['max_abs_err'] for c in cases),
        ms=main_case['ms'], plain_ms=main_case['plain_ms'],
        bound_ms=main_case['bound_ms'], bound_by=main_case['bound_by'],
        library_ms=None, cases=cases), dict(
        name='neighborhood_similarity_backward', route='cuda',
        source='pfst_tpu_torch/ops/csrc/neighborhood_sim.cu',
        replaces='pfst_tpu/ops/pallas_sim.py:112',
        launches=train_bwd, launches_per_request=0,
        launches_per_train_step=train_bwd / (TRAIN_STEPS * len(train)),
        max_abs_err=max(c['max_abs_err'] for c in bwd_cases),
        ms=bwd_case['ms'], plain_ms=bwd_case['plain_ms'],
        bound_ms=bwd_case['bound_ms'], bound_by=bwd_case['bound_by'],
        library_ms=None, cases=bwd_cases)]
    log(f'[train] s/iter batch 2 of {TRAIN_HW}: fp32 {train["fp32"][0]:.4f}, '
        f'bf16 {train["bf16"][0]:.4f} on {card}')
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
