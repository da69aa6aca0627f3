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
   with its median time (per call, and on the device in a CUDA graph of
   ten launches), the plain version's and the memory/compute bound;
3b. the similarity's backward kernel against autograd of the plain
   forward and against the plain gather backward, at the training shape
   (2, 512, 64, 64), both similarity types, fp32 and bf16 input, with
   its time per call and on the device; then at small general geometries
   (k 3, 5, 7; d 1, 2, 33; odd W), checked only; two launches on the
   same inputs must be bitwise equal;
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
   around each run, the EMA teacher checked, s/iter, the host's time
   until each step returns (its enqueue), and the caching allocator's
   retries (``num_alloc_retries``) and the garbage collector's
   collections in the run;
8. one training step card against CPU, 2 x 128x128 crops, full width and
   depth, dropout off, TF32 off: log vars and student gradients;
3c. (run after 3b) each flash-attention kernel (forward, dK/dV, dQ)
   against its plain version at the ViT's shapes (1 and 2 x 12 x 1025 x
   64, fp32 and bf16, read through the strides of the block's qkv
   layout), the microbench's (8 x 12 x {1024, 4096} x 64 bf16) and an
   edge case (1 x 2 x 17 x 64, fp32 and bf16: N inside one tile), with
   the median times of the kernel (per
   call, and on the device in a CUDA graph of ten launches), the plain
   version and SDPA (per call, and on the device: its forward, and its
   backward alone), and the bound;
9. ViT-B/16 UPerNet serving at full width (``upernet_vit-b16_ln_mln``,
   seeded weights): 512x512 requests through ``make_inference_fn`` ->
   ``_finalize_views`` and ``make_state_fn`` -> ``sim_feat``, with the
   flash and similarity launches read around this phase only;
10. ViT card against CPU on one 256x256 image (``img_size=256``), TF32
   off;
11. ViT supervised training at full width: ``build_algorithm`` ->
   ``SupervisedTrainer.init_state`` -> ``make_train_step`` with AdamW and
   the ``adamw_40k`` schedule, 2 x 512x512 crops, fp32 and bf16 autocast,
   launches per step and s/iter; then one step card against CPU at 2 x
   128x128 (``img_size=128``), dropout off, TF32 off;
12. the attention microbench (``tools/attn_microbench_torch.py``) at its
   default shapes;
13. the leaf config's user path at full width on packed synthetic data
   (``tools/make_synthetic_data_torch.py``, ``tools/pack_dataset_torch.py``:
   8 Potsdam-like and 8 + 2 Vaihingen-like 1024x1024 tiles):
   ``train_segmentor`` for 30 iterations (batch 2 of 512x512 crops from the
   source and target pipelines, 4 loader threads, uint8 wire, AdamW
   ``adamw_40k`` over 30 iterations with its warmup scaled to them and
   20x the learning rate, so that 30 iterations from random weights learn,
   checkpoints at 15 and 30, whole-image 1024x1024 eval to mIoU at 30);
   a second run resumed from the checkpoint at 15, which must restore the
   state bitwise and take run A's 16th batch first; ``tools/test_torch.py``
   on the checkpoint at 30, whose mIoU must equal the in-loop one within
   0.01 points; the source decode loss of iterations 26-30 below that of
   1-5; 2 similarity forward and 1 backward launches an iteration; then
   s/iter, the loader stall and the pipelines' host ms per sample beside
   phase 7's bare step;
then one ``{"kernels": [...]}`` line and the ``{"ok": true, ...}`` line.

Imports nothing of JAX and nothing of the JAX package.
"""
import concurrent.futures
import copy
import gc
import importlib.util
import json
import os.path as osp
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.nn.functional as F

from pfst_tpu_torch.apis import (_finalize_views, build_algorithm,
                                 init_segmentor, make_inference_fn,
                                 make_state_fn, train_segmentor)
from pfst_tpu_torch.core import (build_optimizer, load_checkpoint,
                                 restore_state)
from pfst_tpu_torch.core.checkpoint import state_dict_of
from pfst_tpu_torch.datasets import build_dataset
from pfst_tpu_torch.native import hostaug
from pfst_tpu_torch.models import build_train_model
from pfst_tpu_torch.ops import (build, cuda_flash_attention,
                                cuda_flash_attention_backward,
                                cuda_flash_attention_bwd_dkv,
                                cuda_flash_attention_bwd_dq,
                                cuda_neighborhood_similarity,
                                cuda_neighborhood_similarity_backward,
                                torch_attention, torch_attention_backward,
                                torch_neighborhood_similarity,
                                torch_neighborhood_similarity_backward)
from pfst_tpu_torch.utils import Config

ROOT = osp.dirname(osp.abspath(__file__))
LEAF = osp.join(ROOT, 'configs', 'pfst',
                'pfst_pots_irrg2vaih_irrg_deeplabv3plus_r50-d8.py')
VIT = osp.join(ROOT, 'configs', '_base_', 'models',
               'upernet_vit-b16_ln_mln.py')
ADAMW_40K = osp.join(ROOT, 'configs', '_base_', 'schedules',
                     'adamw_40k.py')
MICROBENCH = osp.join(ROOT, 'tools', 'attn_microbench_torch.py')
TOOLS = osp.join(ROOT, 'tools')
# NVIDIA H100 SXM data sheet: HBM3 rate, fp32 (non-tensor-core), dense
# bf16 and TF32 tensor-core peaks; fp32-accurate products on the tensor
# cores take three TF32 products each (3xTF32)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
TF32X3_FLOP_PER_S = 495e12 / 3
SIM_TOL = 1e-5
SIM_K, SIM_D, SIGMA = 3, 2, 30.0
# (shape, sim_type): serving (1024^2 request, make_state_fn), the PFGST
# training loss (2 x 512^2 crops, pfgst_loss.py:95-109) and the ViT
# UPerNet's decoded features at a 512^2 request
SIM_CASES = [((1, 512, 128, 128), 'gaussian'), ((2, 512, 64, 64), 'cosine'),
             ((1, 768, 128, 128), 'gaussian')]
# the similarity kernels' general geometry, small: (shape (B, C, H, W), k,
# d), each for both similarity types and input types: W past a 32-pixel
# segment, odd W (unaligned bf16 pairs), d = 2 with W a multiple of 8
# (the compile-time geometry), C leaving warps without channels or with a
# ragged last stage, k = 7 (8 warps a block) and d > 32 (windows side by
# side)
SIM_GEOMETRY_CASES = [((2, 20, 9, 37), 3, 1),
                      ((1, 70, 11, 64), 3, 2),
                      ((1, 8, 12, 40), 5, 1),
                      ((1, 20, 10, 33), 5, 2),
                      ((2, 36, 7, 48), 5, 2),
                      ((1, 12, 9, 20), 7, 1),
                      ((1, 10, 9, 24), 7, 2),
                      ((1, 3, 37, 70), 3, 33)]
# flash attention: (shape (B, heads, N, d), dtype, layout). 'qkv': q, k, v
# are the strided views of the ViT block's (B, N, 3, heads, d) projection;
# 'contiguous': the microbench's separate (B, heads, N, d) tensors
FLASH_CASES = [((1, 12, 1025, 64), torch.float32, 'qkv'),
               ((1, 12, 1025, 64), torch.bfloat16, 'qkv'),
               ((2, 12, 1025, 64), torch.float32, 'qkv'),
               ((2, 12, 1025, 64), torch.bfloat16, 'qkv'),
               ((8, 12, 1024, 64), torch.bfloat16, 'contiguous'),
               ((8, 12, 4096, 64), torch.bfloat16, 'contiguous'),
               ((1, 2, 17, 64), torch.float32, 'qkv'),
               ((1, 2, 17, 64), torch.bfloat16, 'qkv')]
FLASH_FWD_TOL, FLASH_LSE_TOL, FLASH_BWD_TOL = 2e-5, 1e-5, 1e-4
# the ViT configs' input normalization (ImageNet mean/std, RGB)
VIT_NORM = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375],
                to_rgb=True)
VIT_LAYERS = 12
N_VIT_REQUESTS = 4
VIT_HW, VIT_CHECK_HW, VIT_TRAIN_CHECK_HW = (512, 512), (256, 256), (128, 128)
VIT_TRAIN_STEPS = 8
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
# phase 13: iterations of run A, the checkpoint run B resumes from, the
# iterations whose source decode losses are compared, the samples timed
# per pipeline
LOOP_ITERS, LOOP_RESUME, LOOP_WINDOW, LOOP_SAMPLES = 30, 15, 5, 8
LOOP_MIOU_TOL = 1e-4    # 0.01 points of mIoU
# the learning rate of phase 13 against the config's 6e-5: from random
# weights, 30 iterations at 6e-5 do not lower the source loss beyond what
# the crops' class mix moves it by (it fell in 4 runs of 7 on the H100),
# at 6e-4 in 9 of 10, at 1.2e-3 in 4 of 4, by 0.42-0.54
LOOP_LR_SCALE = 20


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


def graph_ms(fn, reps=20, calls=10):
    """Device time of ``fn``: a CUDA graph that captured ``calls`` calls
    back to back is replayed ``reps`` times; the mean time per call. The
    host path of the call is out of the way, and so is most of a replay's
    own launch cost (about 1 us on the H100, which a graph of one call
    would add to each)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * calls)


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
    """Both CUDA sources and the data pipeline's host kernels at once, one
    compiler each."""
    t0 = time.time()
    names = ('neighborhood_sim', 'flash_attention')
    with concurrent.futures.ThreadPoolExecutor(len(names) + 1) as pool:
        host = pool.submit(hostaug.lib)
        paths = list(pool.map(build.build, names))
        host.result()
    for name, path in zip(names, paths):
        build.load(name)
        log(f'[build] {osp.relpath(path, ROOT)}')
    log(f'[build] {osp.relpath(hostaug.library_path(), ROOT)}')
    log(f'[build] {len(names) + 1} libraries in {time.time() - t0:.1f} s')


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


def sim_errors(x, kernel_size, dilation, sim_type, sigma=SIGMA):
    """The forward kernel on ``x`` as its path calls it (the cosine,
    training, case also saves the per-pixel norms) against the plain
    version: the max |kernel - plain| and the norms' error against
    ``x.norm``, relative where the norm exceeds 1; ``ok`` when both are
    within ``SIM_TOL`` (a NaN fails)."""
    cosine = sim_type == 'cosine'
    out = cuda_neighborhood_similarity(x, kernel_size, dilation, sim_type,
                                       sigma, with_norms=cosine)
    ref = torch_neighborhood_similarity(x, kernel_size, dilation, sim_type,
                                        sigma)
    norm_err = 0.0
    if cosine:
        out, norms = out
        norm_ref = x.float().norm(dim=1)
        norm_err = float(((norms - norm_ref).abs()
                          / norm_ref.clamp(min=1.0)).max())
    err = float((out - ref).abs().max())
    return dict(max_abs_err=err, norm_rel_err=norm_err,
                ok=err <= SIM_TOL and norm_err <= SIM_TOL)


def phase_kernel_vs_plain():
    """Each forward case against its plain version (``sim_errors``), with
    its median time per call (the wrapper's host path included), its
    device time (``graph_ms``), the plain version's time and the
    bound."""
    gen = torch.Generator().manual_seed(0)
    cases = []
    for shape, sim_type in SIM_CASES:
        cosine = sim_type == 'cosine'
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(shape, generator=gen).to('cuda', dtype)

            def kernel():
                return cuda_neighborhood_similarity(
                    x, SIM_K, SIM_D, sim_type, SIGMA, with_norms=cosine)
            err = sim_errors(x, SIM_K, SIM_D, sim_type)
            torch.cuda.synchronize()
            ok = err.pop('ok')
            ms = cuda_time_ms(kernel, 30)
            device_ms = graph_ms(kernel)
            plain_ms = cuda_time_ms(lambda: torch_neighborhood_similarity(
                x, SIM_K, SIM_D, sim_type, SIGMA), 20)
            bound_ms, bound_by = sim_bound(shape, dtype, sim_type)
            case = dict(shape=list(shape), dtype=str(dtype).split('.')[-1],
                        sim_type=sim_type, **err, ms=ms, device_ms=device_ms,
                        plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by=bound_by)
            log(f'[kernel] neighborhood_sim {case}')
            if not ok:
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


def sim_bwd_errors(x, g, kernel_size, dilation, sim_type, sigma=SIGMA):
    """The backward kernel on ``x`` and dL/dsim ``g`` as the training path
    launches it (grad_x in x's type; sim and, for cosine, the norms from
    the forward kernel) against autograd of the plain forward and the
    plain gather backward, both in fp32 on the same input values. Limit
    per element: 1e-5 * max(1, max|ref|), plus for a bf16 grad_x its
    rounding, 2^-8 |ref|; a NaN fails, and so does a second launch on the
    same inputs that is not bitwise equal to the first. ``max_abs_err``
    is the raw max |kernel - autograd|. Returns the errors and the
    callables that phase 3b times: the kernel, autograd of the plain
    forward and the plain gather backward."""
    args = (kernel_size, dilation, sim_type, sigma)
    if sim_type == 'cosine':
        sim, norms = cuda_neighborhood_similarity(x, *args, with_norms=True)
    else:
        sim, norms = cuda_neighborhood_similarity(x, *args), None
    xf = x.float().requires_grad_()
    sim_ref = torch_neighborhood_similarity(xf, *args)
    (auto,) = torch.autograd.grad(sim_ref, xf, g, retain_graph=True)
    plain = torch_neighborhood_similarity_backward(
        xf.detach(), sim_ref.detach(), g, *args)

    def kernel():
        return cuda_neighborhood_similarity_backward(x, sim, g, *args,
                                                     norms=norms)
    out, again = kernel(), kernel()
    limit = 1e-5 * max(1.0, float(auto.abs().max()))
    rounding = 2.0**-8 if x.dtype == torch.bfloat16 else 0.0
    outf = out.float()
    excess = max(float(((outf - ref).abs() - rounding * ref.abs()).max())
                 for ref in (auto, plain))
    repeat = bool(torch.equal(out, again))
    err = dict(max_abs_err=float((outf - auto).abs().max()),
               err_beyond_rounding=excess, limit=limit,
               repeat_bitwise_equal=repeat,
               ok=excess <= limit and repeat
               and bool(torch.isfinite(outf).all()))
    fns = dict(kernel=kernel,
               plain=lambda: torch.autograd.grad(sim_ref, xf, g,
                                                 retain_graph=True),
               gather=lambda: torch_neighborhood_similarity_backward(
                   xf.detach(), sim_ref.detach(), g, *args))
    return err, fns


def phase_backward_vs_plain():
    """The backward kernel against its plain versions (``sim_bwd_errors``)
    at the training shape, both similarity types and input types, with its
    time per call and on the device, the plain versions' times and the
    bound; then at the small general geometries of
    ``SIM_GEOMETRY_CASES``, checked only."""
    gen = torch.Generator().manual_seed(2)
    b, _, h, w = BWD_SHAPE
    cases = []
    for sim_type in ('cosine', 'gaussian'):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(BWD_SHAPE, generator=gen).to('cuda', dtype)
            g = torch.randn((b, SIM_K**2, h, w), generator=gen).cuda()
            err, fns = sim_bwd_errors(x, g, SIM_K, SIM_D, sim_type)
            torch.cuda.synchronize()
            ok = err.pop('ok')
            ms = cuda_time_ms(fns['kernel'], 30)
            device_ms = graph_ms(fns['kernel'])
            plain_ms = cuda_time_ms(fns['plain'], 20)
            gather_ms = cuda_time_ms(fns['gather'], 20)
            bound_ms, bound_by = sim_bwd_bound(BWD_SHAPE, dtype, sim_type)
            case = dict(shape=list(BWD_SHAPE), dtype=str(dtype).split('.')[-1],
                        sim_type=sim_type, **err, ms=ms,
                        device_ms=device_ms, plain_ms=plain_ms,
                        plain_gather_ms=gather_ms,
                        bound_ms=bound_ms, bound_by=bound_by)
            log(f'[kernel] neighborhood_sim backward {case}')
            if not ok:
                raise AssertionError(f'backward kernel disagrees with the '
                                     f'plain version: {case}')
            cases.append(case)
            del fns
    geometry = []
    for shape, k, d in SIM_GEOMETRY_CASES:
        for sim_type in ('cosine', 'gaussian'):
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.randn(shape, generator=gen).to('cuda', dtype)
                g = torch.randn((shape[0], k * k, *shape[2:]),
                                generator=gen).cuda()
                err, _ = sim_bwd_errors(x, g, k, d, sim_type)
                ok = err.pop('ok')
                case = dict(shape=list(shape), k=k, d=d, sim_type=sim_type,
                            dtype=str(dtype).split('.')[-1], **err)
                if not ok:
                    raise AssertionError(f'backward kernel disagrees with '
                                         f'the plain version: {case}')
                geometry.append(case)
    log(f'[kernel] neighborhood_sim backward: {len(geometry)} general-'
        f'geometry cases within their limits, repeat launches bitwise '
        f'equal; max excess '
        f'{max(c["err_beyond_rounding"] - c["limit"] for c in geometry):.2e}'
        f' beyond the limit')
    return cases, geometry


def _flash_inputs(shape, dtype, layout, gen):
    b, h, n, d = shape
    if layout == 'qkv':
        qkv = torch.randn((b, n, 3, h, d), generator=gen).to('cuda', dtype)
        return qkv.permute(2, 0, 3, 1, 4).unbind(0)
    return [torch.randn(shape, generator=gen).to('cuda', dtype)
            for _ in range(3)]


def flash_bounds(shape, dtype):
    """Least times (ms, bound_by) of the forward, dK/dV and dQ kernels'
    functions: each input read once and each output written once over the
    HBM rate, against the operations over the peak of the input type:
    bf16 at the tensor cores' 989 TFLOP/s; fp32 at 495 / 3 = 165 TFLOP/s,
    the tensor cores' rate for fp32-accurate products as 3xTF32, which is
    above the CUDA cores' 67, so no fp32 kernel can read faster than its
    bound. Forward:
    4 B H N^2 d flops (S = Q K^T and P V). The whole backward needs
    10 B H N^2 d (S recomputed, dP = dO V^T, dV, dK, dQ: 2 each), split
    6 : 4 here, dK/dV taking S, dV and dK and dQ taking dP and dQ. Bytes:
    forward q, k, v, O and the fp32 LSE; dK/dV q, k, v, dO, LSE and Di
    in, dK and dV out; dQ the same inputs, dQ out."""
    b, h, n, d = shape
    elt = torch.finfo(dtype).bits // 8
    peak = (BF16_FLOP_PER_S if dtype == torch.bfloat16
            else TF32X3_FLOP_PER_S)
    mat, stat = b * h * n * d * elt, b * h * n * 4
    work = {'fwd': (4 * mat + stat, 4), 'dkv': (6 * mat + 2 * stat, 6),
            'dq': (5 * mat + 2 * stat, 4)}
    out = {}
    for kernel, (nbytes, per) in work.items():
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = per * b * h * n * n * d / peak
        out[kernel] = (max(t_bytes, t_ops) * 1e3,
                       'bytes' if t_bytes >= t_ops else 'operations')
    return out


def flash_allowances(qf, kf, vf, gf, o, lse, scale):
    """What bf16 kernels may differ by from the fp32 plain versions beyond
    the fp32 limits, propagated from the roundings they share with the
    TPU kernel: ``(O, dQ, dK, dV)``, each shaped like its output, from the
    fp32 inputs' values, the plain fp32 ``o`` and ``lse`` and dL/dO ``gf``.
    eps = 2^-8 bounds one rounding to bf16 (2^-9 to nearest, doubled for
    the fp32 sums around it):

    * P rounded before P V: eps P|V| (O);
    * P^T rounded before P^T dO: eps P^T|dO| (dV);
    * dS^T s rounded before (dS^T s) Q: eps s |dS|^T |Q| (dK);
    * dS s rounded before (dS s) K: eps s |dS| |K| (dQ);
    * the bf16 O that Di = rowsum(dO O) reads (the library's backward
      reads its bf16 O too): |dDi| <= eps rowsum|O dO|, reaching dQ as
      s |dDi| P|K| and dK as s P^T(|dDi| |Q|).

    Each output's own rounding, eps |ref|, is ``flash_excess``'s."""
    eps = 2.0**-8
    p = torch.exp(torch.matmul(qf, kf.transpose(-1, -2)) * scale
                  - lse[..., None])
    ddi = eps * (o.abs() * gf.abs()).sum(-1, keepdim=True)
    al_o = eps * torch.matmul(p, vf.abs())
    al_dq = scale * ddi * torch.matmul(p, kf.abs())
    al_dv = eps * torch.matmul(p.transpose(-1, -2), gf.abs())
    al_dk = scale * torch.matmul(p.transpose(-1, -2), ddi * qf.abs())
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    ds_abs = p.mul_(dp.sub_((o * gf).sum(-1, keepdim=True))).abs_()
    del dp
    al_dk += eps * scale * torch.matmul(ds_abs.transpose(-1, -2), qf.abs())
    al_dq += eps * scale * torch.matmul(ds_abs, kf.abs())
    return al_o, al_dq, al_dk, al_dv


def flash_excess(got, ref, rounding, allowance):
    """max(|got - ref| - rounding |ref| - allowance): how far ``got`` lies
    beyond its own rounding and the propagated allowance; a NaN counts as
    infinitely far (Python's ``max`` over floats would skip it)."""
    return float(((got.float() - ref).abs() - rounding * ref.abs()
                  - allowance).nan_to_num(nan=float('inf')).max())


def flash_errors(q, k, v, g, scale):
    """The three flash kernels on (q, k, v) and dL/dO ``g`` against the
    plain versions, with the limits of phase 3c. Returns ``(o, lse,
    errors)``; ``errors`` holds each excess beyond its allowance next to
    its limit, the raw max |kernel - ref| of O and of dQ, dK, dV against
    autograd and, for bf16 input, for information, the max |kernel -
    plain| with the plain versions run in bf16."""
    bf16 = q.dtype == torch.bfloat16
    rounding = 2.0**-8 if bf16 else 0.0
    o, lse = cuda_flash_attention(q, k, v, scale)
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    ref, ref_lse = torch_attention(qf, kf, vf, scale, return_lse=True)
    spread = (flash_allowances(qf, kf, vf, gf, ref, ref_lse, scale) if bf16
              else (0.0,) * 4)
    err = dict(fwd_err=float((o.float() - ref).abs().max()),
               fwd_excess=flash_excess(o, ref, rounding, spread[0]),
               fwd_limit=FLASH_FWD_TOL * max(1.0, float(ref.abs().max())),
               lse_rel_err=float(((lse - ref_lse).abs()
                                  / ref_lse.abs()).max()))
    grads = cuda_flash_attention_backward(q, k, v, o, lse, g, scale)
    xs = [t.clone().requires_grad_() for t in (qf, kf, vf)]
    auto = torch.autograd.grad(torch_attention(*xs, scale), xs, gf)
    plain = torch_attention_backward(qf, kf, vf, ref, ref_lse, gf, scale)
    err['bwd_limit'] = FLASH_BWD_TOL * max(1.0, max(float(a.abs().max())
                                                    for a in auto))
    err['bwd_excess'] = max(
        flash_excess(got, r, rounding, e)
        for got, a, pl, e in zip(grads, auto, plain, spread[1:])
        for r in (a, pl))
    for name, got, a in zip(('dq_err', 'dk_err', 'dv_err'), grads, auto):
        err[name] = float((got.float() - a).abs().max())
    del spread, auto, plain, xs
    if bf16:
        po, plse = torch_attention(q, k, v, scale, return_lse=True)
        err['fwd_err_plain_bf16'] = float((o.float() - po.float()).abs()
                                          .max())
        err['bwd_err_plain_bf16'] = max(
            float((a.float() - b.float()).abs().max()) for a, b in zip(
                grads, torch_attention_backward(q, k, v, po, plse, g, scale)))
    err['ok'] = (err['fwd_excess'] <= err['fwd_limit']
                 and err['lse_rel_err'] <= FLASH_LSE_TOL
                 and err['bwd_excess'] <= err['bwd_limit'])
    return o, lse, err


def sdpa_backward_ms(out, g):
    """Device time of SDPA's backward alone: the backward node that
    autograd would call for ``out`` (whichever backend SDPA chose), called
    directly under ``graph_ms``, so the forward stays outside the timed
    graph."""
    node = out.grad_fn

    def backward():
        with torch.no_grad():
            return node(g)
    return graph_ms(backward)


def phase_flash_vs_plain():
    """Each flash kernel against its plain version on the same inputs, as
    the path launches it (bf16 or fp32, q, k, v through their strides).

    Forward: O within ``FLASH_FWD_TOL * max(1, max|ref|)`` of the plain
    forward in fp32 on the same input values (fp32 sums in another
    order), plus for a bf16 O its rounding 2^-8 |ref|; LSE within
    ``FLASH_LSE_TOL`` relative. Backward: dQ, dK, dV against autograd of
    the plain fp32 forward and against ``torch_attention_backward``, on
    the same values and a random dL/dO, within ``FLASH_BWD_TOL * max(1,
    max|ref|)``: sums of N = 1025 to 4096 fp32 terms in another order
    (the fp32 kernels measured <= 8.1e-6 as 3xTF32, <= 6.9e-7 as fp32
    FMAs on the CUDA cores). For bf16 input, each output's own
    rounding, 2^-8 |ref|, and the roundings that ``flash_allowances``
    propagates: P (forward), P^T and dS^T s (dK/dV), dS s (dQ), and the
    bf16 O that Di reads. ``max_abs_err`` is the raw max |kernel - ref|.
    SDPA is timed per call (forward; forward's autograd backward) and on
    the device (``library_device_ms``: forward, and its backward node
    alone)."""
    gen = torch.Generator().manual_seed(4)
    cases = []
    for shape, dtype, layout in FLASH_CASES:
        q, k, v = _flash_inputs(shape, dtype, layout, gen)
        g = torch.randn(shape, generator=gen).to('cuda', dtype)
        scale = shape[-1]**-0.5
        o, lse, err = flash_errors(q, k, v, g, scale)
        gf = g.float()
        di = (o.float() * gf).sum(-1).contiguous()
        ms = {'fwd': cuda_time_ms(lambda: cuda_flash_attention(
                  q, k, v, scale), 10),
              'dkv': cuda_time_ms(lambda: cuda_flash_attention_bwd_dkv(
                  q, k, v, g, lse, di, scale), 10),
              'dq': cuda_time_ms(lambda: cuda_flash_attention_bwd_dq(
                  q, k, v, g, lse, di, scale), 10)}
        device_ms = {
            'fwd': graph_ms(lambda: cuda_flash_attention(q, k, v, scale)),
            'dkv': graph_ms(lambda: cuda_flash_attention_bwd_dkv(
                q, k, v, g, lse, di, scale)),
            'dq': graph_ms(lambda: cuda_flash_attention_bwd_dq(
                q, k, v, g, lse, di, scale))}
        plain_fwd_ms = cuda_time_ms(lambda: torch_attention(q, k, v, scale),
                                    5)
        plain_bwd_ms = cuda_time_ms(lambda: torch_attention_backward(
            q, k, v, o, lse, g, scale), 5)
        lib_fwd_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, scale=scale), 10)
        xs = [t.detach().requires_grad_() for t in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*xs, scale=scale)
        lib_bwd_ms = cuda_time_ms(lambda: torch.autograd.grad(
            lib_out, xs, g, retain_graph=True), 10)
        lib_device_ms = {
            'fwd': graph_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, scale=scale)),
            'bwd': sdpa_backward_ms(lib_out, g)}
        lib_bwd_op = lib_out.grad_fn.name()
        del xs, lib_out, di, o, lse
        bounds = flash_bounds(shape, dtype)
        ok = err.pop('ok')
        case = dict(shape=list(shape), dtype=str(dtype).split('.')[-1],
                    layout=layout, **err, ms=ms, device_ms=device_ms,
                    plain_fwd_ms=plain_fwd_ms,
                    plain_bwd_ms=plain_bwd_ms, library_fwd_ms=lib_fwd_ms,
                    library_bwd_ms=lib_bwd_ms,
                    library_device_ms=lib_device_ms,
                    library_bwd_op=lib_bwd_op,
                    bound_ms={kk: b[0] for kk, b in bounds.items()},
                    bound_by={kk: b[1] for kk, b in bounds.items()})
        log(f'[kernel] flash_attention {case}')
        if not ok:
            raise AssertionError(f'flash kernels disagree with the plain '
                                 f'versions: {case}')
        cases.append(case)
        del q, k, v, g, gf
        torch.cuda.empty_cache()
    return cases


def _flash_counts():
    return (cuda_flash_attention.launches,
            cuda_flash_attention_bwd_dkv.launches,
            cuda_flash_attention_bwd_dq.launches)


def _reset_counts():
    cuda_flash_attention.launches = 0
    cuda_flash_attention_bwd_dkv.launches = 0
    cuda_flash_attention_bwd_dq.launches = 0
    cuda_neighborhood_similarity.launches = 0
    cuda_neighborhood_similarity_backward.launches = 0


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
    retries = torch.cuda.memory_stats().get('num_alloc_retries', 0)
    collections = sum(g['collections'] for g in gc.get_stats())
    cuda_neighborhood_similarity.launches = 0
    cuda_neighborhood_similarity_backward.launches = 0
    times, enqueue = [], []
    for i in range(TRAIN_STEPS):
        batch = _train_batch(cfg, 1000 + i, TRAIN_HW)
        if i == 1:
            a = min(1.0 - 1.0 / (state.step + 1.0), algo.alpha)
            teacher0 = state.teacher.get_parameter(probe).detach().clone()
            student0 = state.student.get_parameter(probe).detach().clone()
        torch.cuda.synchronize()
        t0 = time.time()
        state, log_vars = step(state, batch, gen)
        enqueue.append(time.time() - t0)
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
    retries = torch.cuda.memory_stats().get('num_alloc_retries', 0) - retries
    collections = sum(g['collections'] for g in gc.get_stats()) - collections
    moved = float((state.student.get_parameter(probe).detach() - start)
                  .abs().max())
    s_iter = statistics.median(times[TRAIN_WARMUP:])
    log(f'[train {name}] {TRAIN_STEPS} steps, batch 2 of {TRAIN_HW}: s/iter '
        f'{[round(t, 5) for t in times]}, median after {TRAIN_WARMUP} '
        f'warm-ups {s_iter:.4f} s on {card}; kernel launches fwd '
        f'{launches[0]} bwd {launches[1]}; host enqueue ms '
        f'{[round(t * 1e3, 1) for t in enqueue]}; allocator retries '
        f'{retries}; garbage collections {collections}; '
        f'student moved {moved:.3e}; '
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
    _check_train_sides(sides, threads,
                       f'[train card-vs-cpu] {CHECK_HW}, residual scale '
                       f'{RESIDUAL_SCALE}')


def _check_train_sides(sides, threads, tag):
    """Card step against the CPU step (``sides``: log vars and gradient
    groups of 'card', 'cpu' and 'cpu1', the CPU with one thread): log vars
    within rtol 1e-3 (atol 1e-5); gradients with cosine similarity >=
    0.9999 and norms within 1e-3 over all parameters; no parameter tensor
    with a zero gradient."""
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
    log(f'{tag}: '
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


def vit_config(img_size=VIT_HW[0], dtype=None):
    """The ViT-B/16 UPerNet config at full width and depth, for inputs of
    ``img_size`` (no position-embedding resize), with the ViT configs'
    input normalization."""
    cfg = Config.fromfile(VIT)
    cfg.img_norm_cfg = dict(VIT_NORM)
    cfg.model['backbone']['img_size'] = img_size
    if dtype:
        cfg.model['dtype'] = dtype
    return cfg


def phase_vit_serving(cfg, model):
    """512x512 requests: logits -> labels, then the feature state through
    the similarity kernel. Per request: 2 x 12 flash forwards (the two
    full forwards of make_inference_fn and make_state_fn), 1 similarity
    forward, no backward."""
    infer = make_inference_fn(model)
    state_fn = make_state_fn(model)
    imgs = [_request(cfg, 200 + seed, VIT_HW)
            for seed in range(N_VIT_REQUESTS)]
    torch.cuda.synchronize()
    _reset_counts()
    times = []
    for i, img in enumerate(imgs):
        t0 = time.time()
        img = img.cuda()
        logits = infer(img)
        labels = _finalize_views(model, [logits], [{'flip': False}], VIT_HW)
        sim = state_fn(img)['sim_feat'].cpu()
        torch.cuda.synchronize()
        times.append((time.time() - t0) * 1e3)
        h, w = VIT_HW[0] // 4, VIT_HW[1] // 4
        if labels.shape != VIT_HW or not (
                0 <= labels.min() and labels.max() < model.num_classes) or \
                not torch.isfinite(logits).all():
            raise AssertionError(f'ViT request {i}: bad output')
        if tuple(sim.shape) != (1, SIM_K**2, h, w) or \
                not torch.isfinite(sim).all() or \
                not (0 <= float(sim.min()) and float(sim.max()) <= 1):
            raise AssertionError(f'ViT request {i}: bad sim_feat '
                                 f'{tuple(sim.shape)}')
    counts = _flash_counts()
    sim_launches = cuda_neighborhood_similarity.launches
    warm = statistics.median(times[1:])
    log(f'[vit serve] {N_VIT_REQUESTS} requests of {VIT_HW}: ms per '
        f'request {[round(t, 2) for t in times]}, warm median {warm:.2f}; '
        f'flash launches fwd/dkv/dq {counts}, similarity {sim_launches}')
    want = (2 * VIT_LAYERS * N_VIT_REQUESTS, 0, 0)
    if counts != want or sim_launches != N_VIT_REQUESTS:
        raise AssertionError(f'ViT serving launched flash {counts} (want '
                             f'{want}) and similarity {sim_launches}')
    return dict(flash=counts, sim=sim_launches, ms=times, warm_ms=warm)


def phase_vit_card_vs_cpu():
    """One 256x256 image, the model built at img_size 256, TF32 off:
    logits within 1e-3 max|logit|, argmax agreement >= 99.9 %."""
    cfg = vit_config(VIT_CHECK_HW[0])
    model = init_segmentor(cfg)
    cpu_model = copy.deepcopy(model).cpu()
    img = _request(cfg, 300, VIT_CHECK_HW)
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        card_logits = make_inference_fn(model)(img.cuda()).cpu()
        cpu_logits = make_inference_fn(cpu_model)(img)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old
    scale = float(cpu_logits.abs().max())
    err = float((card_logits - cpu_logits).abs().max())
    agree = float((card_logits.argmax(1) == cpu_logits.argmax(1))
                  .float().mean())
    log(f'[vit card-vs-cpu] {VIT_CHECK_HW}: logit err {err:.3e} (limit '
        f'{1e-3 * scale:.3e}), argmax agreement {agree:.6f}')
    if not (err <= 1e-3 * scale and agree >= 0.999):
        raise AssertionError('ViT card and CPU disagree')


def _vit_train_cfg(img_size, dtype=None, dropout=True):
    """The ViT config with the ``adamw_40k`` schedule (AdamW, poly with
    linear warmup, 40k iterations) composed in."""
    cfg = vit_config(img_size, dtype)
    sched = Config.fromfile(ADAMW_40K)
    for key in ('optimizer', 'optimizer_config', 'lr_config', 'runner'):
        cfg[key] = sched[key]
    if not dropout:
        cfg.model['decode_head']['dropout_ratio'] = 0.0
        cfg.model['auxiliary_head']['dropout_ratio'] = 0.0
    return cfg


def _vit_train_setup(cfg, device='cuda'):
    algo = build_algorithm(cfg, device=device)
    opt_cfg = cfg.get('optimizer_config') or {}
    tx = build_optimizer(cfg.optimizer, cfg.get('lr_config'),
                         cfg.runner['max_iters'], opt_cfg.get('grad_clip'))
    state = algo.init_state(torch.Generator().manual_seed(0), tx)
    norm = cfg.img_norm_cfg
    return algo, state, algo.make_train_step(norm['mean'], norm['std'])


def _vit_batch(cfg, seed, hw):
    """2 seeded uint8-noise images, normalized, and labels of the
    config's classes in 32x32 blocks with a band of 255 across the top,
    on the card."""
    rs = np.random.RandomState(seed)
    norm = cfg.img_norm_cfg
    mean = np.asarray(norm['mean'], np.float32).reshape(1, 3, 1, 1)
    std = np.asarray(norm['std'], np.float32).reshape(1, 3, 1, 1)
    img = rs.randint(0, 256, (2, 3, *hw)).astype(np.float32)
    num_classes = cfg.model['decode_head']['num_classes']
    cells = rs.randint(0, num_classes, (2, hw[0] // 32, hw[1] // 32))
    gt = cells.repeat(32, axis=1).repeat(32, axis=2)
    gt[:, :hw[0] // 16] = 255
    return dict(img=torch.from_numpy((img - mean) / std).cuda(),
                gt_semantic_seg=torch.from_numpy(gt).cuda())


def _vit_train_run(name, dtype, card):
    """VIT_TRAIN_STEPS steps at full width on 2 x 512^2 crops; returns
    (s/iter, flash launches (fwd, dkv, dq) in the run)."""
    cfg = _vit_train_cfg(VIT_HW[0], dtype)
    _, state, step = _vit_train_setup(cfg)
    gen = torch.Generator().manual_seed(3)
    probe = 'decode_head.conv_seg.weight'
    start = state.student.get_parameter(probe).detach().clone()
    batches = [_vit_batch(cfg, 2000 + i, VIT_HW)
               for i in range(VIT_TRAIN_STEPS)]
    torch.cuda.synchronize()
    _reset_counts()
    times = []
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.time()
        state, log_vars = step(state, batch, gen)
        torch.cuda.synchronize()
        times.append(time.time() - t0)
        vals = {k: float(v) for k, v in log_vars.items()}
        if not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f'[vit train {name}] step {i}: non-finite '
                                 f'log vars {vals}')
    counts = _flash_counts()
    moved = float((state.student.get_parameter(probe).detach() - start)
                  .abs().max())
    s_iter = statistics.median(times[TRAIN_WARMUP:])
    log(f'[vit train {name}] {VIT_TRAIN_STEPS} steps, batch 2 of {VIT_HW}: '
        f's/iter {[round(t, 4) for t in times]}, median after '
        f'{TRAIN_WARMUP} warm-ups {s_iter:.4f} s on {card}; flash launches '
        f'fwd/dkv/dq {counts}; moved {moved:.3e}; last log vars '
        f'{json.dumps({k: round(v, 6) for k, v in vals.items()})}')
    if counts != (VIT_LAYERS * VIT_TRAIN_STEPS,) * 3:
        raise AssertionError(f'[vit train {name}] expected '
                             f'{VIT_LAYERS} launches of each flash kernel '
                             f'per step, got {counts}')
    if not moved > 0:
        raise AssertionError(f'[vit train {name}] the model did not change')
    return s_iter, counts


def phase_vit_train(card):
    results = {}
    for name, dtype in (('fp32', None), ('bf16', 'bfloat16')):
        results[name] = _vit_train_run(name, dtype, card)
        torch.cuda.empty_cache()
    return results


def phase_vit_train_card_vs_cpu():
    """One supervised step on the card and on the CPU from the same
    weights and batch at 2 x 128^2 (img_size 128), dropout off, TF32 off,
    held as phase 8 holds the PFGST step."""
    cfg = _vit_train_cfg(VIT_TRAIN_CHECK_HW[0], dropout=False)
    batch = {k: v.cpu() for k, v in
             _vit_batch(cfg, 7, VIT_TRAIN_CHECK_HW).items()}
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
            _, state, step = _vit_train_setup(cfg, device)
            _, log_vars = step(state, {k: v.to(device)
                                       for k, v in batch.items()},
                               torch.Generator().manual_seed(5))
            sides[side] = ({k: float(v) for k, v in log_vars.items()},
                           _grad_groups(state))
    finally:
        torch.set_num_threads(threads)
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old
    _check_train_sides(sides, threads,
                       f'[vit train card-vs-cpu] {VIT_TRAIN_CHECK_HW}')


def phase_microbench():
    """``tools/attn_microbench_torch.py`` at its default shapes."""
    spec = importlib.util.spec_from_file_location('attn_microbench_torch',
                                                  MICROBENCH)
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    log('[microbench] shape, mode, naive / flash / library (SDPA) '
        'best/median ms, bf16')
    return bench.bench_rows()


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, osp.join(TOOLS, f'{name}.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _loop_config(pots, vaih):
    """The leaf config on the synthetic roots: log every iteration,
    checkpoints every LOOP_RESUME, eval at LOOP_ITERS, ``adamw_40k``'s
    AdamW and poly schedule with the learning rate LOOP_LR_SCALE times the
    config's and the warmup (1500 of 40000) scaled to the run, and the
    test set pointed at the validation set so the two evaluations
    compare."""
    cfg = Config.fromfile(LEAF)
    warmup = round(cfg.lr_config['warmup_iters'] * LOOP_ITERS
                   / cfg.runner['max_iters'])
    cfg.merge_from_dict({
        'data.train.source.data_root': pots,
        'data.train.target.data_root': vaih,
        'data.val.data_root': vaih, 'data.test.data_root': vaih,
        'data.test.img_dir': cfg.data.val.img_dir,
        'data.test.ann_dir': cfg.data.val.ann_dir,
        'log_config.interval': 1,
        'checkpoint_config.interval': LOOP_RESUME,
        'evaluation.interval': LOOP_ITERS,
        'lr_config.warmup_iters': warmup,
        'optimizer.lr': cfg.optimizer['lr'] * LOOP_LR_SCALE})
    return cfg


def _pipeline_ms(cfg):
    """Host ms per sample of the source and target pipelines, each run
    alone in this thread on LOOP_SAMPLES samples."""
    from pfst_tpu_torch.apis.train import apply_device_normalize
    ds = build_dataset(apply_device_normalize(cfg.copy())
                       .data['train'])
    out = {}
    for name, sub in (('source', ds.source), ('target', ds.target)):
        times = []
        for i in range(LOOP_SAMPLES):
            t0 = time.perf_counter()
            sub[i % len(sub)]
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = statistics.median(times)
    return out


def _sim_counts():
    return (cuda_neighborhood_similarity.launches,
            cuda_neighborhood_similarity_backward.launches)


def _check_launches(name, counts, iters):
    if counts != (2 * iters, iters):
        raise AssertionError(f'[loop] {name}: expected {2 * iters} forward '
                             f'and {iters} backward similarity launches, '
                             f'got {counts}')


def _check_restored(cfg, path):
    """A state restored from ``path`` as ``train_segmentor`` restores it
    equals what the file holds, bitwise: student, teacher, the
    optimizer's moments and step, the LR schedule and the step."""
    ckpt = load_checkpoint(path)
    algo = build_algorithm(cfg)
    opt_cfg = cfg.get('optimizer_config') or {}
    tx = build_optimizer(cfg.optimizer, cfg.get('lr_config'), LOOP_ITERS,
                         opt_cfg.get('grad_clip'))
    state = restore_state(algo.init_state(torch.Generator().manual_seed(0),
                                          tx), ckpt)
    got, want = state_dict_of(state), ckpt['state_dict']
    bad = [k for k in want if not torch.equal(got[k].cpu(), want[k])]
    if got.keys() != want.keys():
        bad.append('key sets differ')
    opt_state = state.optimizer.optimizer.state_dict()['state']
    for i, saved in ckpt['optimizer']['state'].items():
        for k, v in saved.items():
            if not torch.equal(opt_state[i][k].cpu(), v):
                bad.append(f'optimizer {i} {k}')
    if state.optimizer.scheduler.state_dict()['last_epoch'] != \
            ckpt['scheduler']['last_epoch'] or state.step != LOOP_RESUME:
        bad.append(f'step {state.step}')
    if bad:
        raise AssertionError(f'[loop] restore of {path} differs: {bad[:8]}')
    n_moments = sum(len(v) for v in opt_state.values())
    del state, algo
    torch.cuda.empty_cache()
    return len(want), n_moments


def phase_loop(card, bare_s_iter):
    """Phase 13: the leaf config through its entry points on the card."""
    t_phase = time.time()
    root = tempfile.mkdtemp(prefix='pfst_loop_')
    try:
        pots, vaih = osp.join(root, 'pots'), osp.join(root, 'vaih')
        synth, pack = (_tool('make_synthetic_data_torch'),
                       _tool('pack_dataset_torch'))
        synth.main(['-o', pots, '--num-train', '8', '--num-val', '0'])
        synth.main(['-o', vaih, '--num-train', '8', '--num-val', '2',
                    '--seed', '1'])
        pack.main([root, '--recursive'])
        t_data = time.time() - t_phase
        cfg = _loop_config(pots, vaih)
        host_ms = _pipeline_ms(cfg)

        runs = {}
        for name, kwargs in (
                ('A', {}),
                ('B', dict(resume_from=osp.join(root, 'A',
                                                f'iter_{LOOP_RESUME}.pth'),
                           validate=False))):
            hist = []
            torch.cuda.synchronize()
            _reset_counts()
            t0 = time.time()
            train_segmentor(cfg.copy(), work_dir=osp.join(root, name),
                            max_iters_override=LOOP_ITERS, seed=0,
                            history=hist, **kwargs)
            torch.cuda.synchronize()
            runs[name] = dict(hist=hist, wall=time.time() - t0,
                              counts=_sim_counts())
            torch.cuda.empty_cache()
        a, b = runs['A']['hist'], runs['B']['hist']
        _check_launches('run A', runs['A']['counts'], LOOP_ITERS)
        _check_launches('run B', runs['B']['counts'],
                        LOOP_ITERS - LOOP_RESUME)
        n_tensors, n_moments = _check_restored(
            cfg, osp.join(root, 'A', f'iter_{LOOP_RESUME}.pth'))
        batches_a = {h['iter']: h['indices'] for h in a if h['kind'] ==
                     'batch'}
        first_b = next(h for h in b if h['kind'] == 'batch')
        if first_b['iter'] != LOOP_RESUME + 1 or \
                first_b['indices'] != batches_a[LOOP_RESUME + 1]:
            raise AssertionError(f'[loop] run B began with batch {first_b}, '
                                 f'run A took {batches_a[LOOP_RESUME + 1]}')

        loop_miou = next(h['metrics']['mIoU'] for h in a
                         if h['kind'] == 'eval')
        cfg_path = osp.join(root, 'loop_config.py')
        cfg.dump(cfg_path)
        t0 = time.time()
        res = _tool('test_torch').main([
            cfg_path, osp.join(root, 'A', f'iter_{LOOP_ITERS}.pth'),
            '--eval', 'mIoU'])
        t_test = time.time() - t0
        if abs(res['mIoU'] - loop_miou) > LOOP_MIOU_TOL + 1e-12:
            raise AssertionError(f'[loop] tools/test_torch.py mIoU '
                                 f'{res["mIoU"]} != in-loop {loop_miou}')

        logs = {h['iter']: h for h in a if h['kind'] == 'log'}
        loss = [logs[i]['log_vars']['decode.loss_ce']
                for i in range(1, LOOP_ITERS + 1)]
        first = statistics.mean(loss[:LOOP_WINDOW])
        last = statistics.mean(loss[-LOOP_WINDOW:])
        if not (np.isfinite(loss).all() and last < first):
            raise AssertionError(f'[loop] source decode loss did not fall: '
                                 f'{first:.4f} -> {last:.4f} ({loss})')
        times = [logs[i]['time'] for i in range(LOOP_WINDOW + 1,
                                                LOOP_ITERS + 1)]
        stall = [logs[i]['data'] for i in range(LOOP_WINDOW + 1,
                                                LOOP_ITERS + 1)]
        out = dict(
            s_iter_min=min(times), s_iter_median=statistics.median(times),
            s_iter_max=max(times), data_stall_median=statistics.median(stall),
            data_stall_max=max(stall), bare_step_s_iter=bare_s_iter,
            host_ms_per_sample=host_ms, loss_first=first, loss_last=last,
            miou_loop=loop_miou, miou_test=res['mIoU'],
            launches=runs['A']['counts'], launches_b=runs['B']['counts'],
            wall_a=runs['A']['wall'], wall_b=runs['B']['wall'],
            data_s=t_data, test_s=t_test)
        log(f'[loop] data: 18 tiles written and packed in {t_data:.1f} s; '
            f'restore of iter {LOOP_RESUME} bitwise ({n_tensors} tensors, '
            f'{n_moments} optimizer state tensors); run B began with run '
            f'A\'s batch {LOOP_RESUME + 1} {first_b["indices"]}')
        log(f'[loop] mIoU in the loop {loop_miou} / tools/test_torch.py '
            f'{res["mIoU"]} ({t_test:.1f} s); source decode loss '
            f'iterations 1-{LOOP_WINDOW} {first:.4f} -> '
            f'{LOOP_ITERS - LOOP_WINDOW + 1}-{LOOP_ITERS} {last:.4f}; '
            f'similarity launches run A {runs["A"]["counts"]} run B '
            f'{runs["B"]["counts"]}')
        log(f'[loop] s/iter past iteration {LOOP_WINDOW}: min '
            f'{out["s_iter_min"]:.4f} median {out["s_iter_median"]:.4f} max '
            f'{out["s_iter_max"]:.4f} (per iteration '
            f'{[round(t, 4) for t in times]}); bare step (phase 7, fp32) '
            f'{bare_s_iter:.4f} on {card}')
        log(f'[loop] data stall s/iter: median {out["data_stall_median"]:.4f}'
            f' max {out["data_stall_max"]:.4f} '
            f'({[round(t, 4) for t in stall]}); host ms per sample alone: '
            f'source {host_ms["source"]:.1f}, target {host_ms["target"]:.1f}; '
            f'run A {runs["A"]["wall"]:.1f} s, run B {runs["B"]["wall"]:.1f} '
            f's, phase {time.time() - t_phase:.1f} s')
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _flash_entries(cases, serve, train):
    """The kernels-line entries of the three flash kernels: times of the
    serving shape (forward) and the training shape (backward), fp32."""
    fwd = next(c for c in cases if c['shape'] == [1, 12, 1025, 64]
               and c['dtype'] == 'float32')
    bwd = next(c for c in cases if c['shape'] == [2, 12, 1025, 64]
               and c['dtype'] == 'float32')
    lib = 'jax/experimental/pallas/ops/tpu/flash_attention.py'
    steps = VIT_TRAIN_STEPS * len(train)
    rows = []
    for i, (name, kernel, line, case) in enumerate((
            ('flash_attention', 'fwd', 589, fwd),
            ('flash_attention_bwd_dkv', 'dkv', 941, bwd),
            ('flash_attention_bwd_dq', 'dq', 1287, bwd))):
        train_launches = sum(t[1][i] for t in train.values())
        errs = [c['fwd_err'] if i == 0 else
                max(c['dk_err'], c['dv_err']) if i == 1 else c['dq_err']
                for c in cases]
        rows.append(dict(
            name=name, route='cuda',
            source='pfst_tpu_torch/ops/csrc/flash_attention.cu',
            replaces=f'{lib}:{line}',
            called_from='tools/attn_microbench.py:30',
            launches=serve['flash'][i] + train_launches,
            launches_per_request=serve['flash'][i] / N_VIT_REQUESTS,
            launches_per_train_step=train_launches / steps,
            max_abs_err=max(errs),
            max_abs_err_fp32=max(e for e, c in zip(errs, cases)
                                 if c['dtype'] == 'float32'),
            ms=case['ms'][kernel], device_ms=case['device_ms'][kernel],
            plain_ms=case['plain_fwd_ms'] if i == 0
            else case['plain_bwd_ms'],
            bound_ms=case['bound_ms'][kernel],
            bound_by=case['bound_by'][kernel],
            library_ms=case['library_fwd_ms'] if i == 0
            else case['library_bwd_ms'],
            library_device_ms=case['library_device_ms'][
                'fwd' if i == 0 else 'bwd'],
            library_bwd_op=case['library_bwd_op'],
            timed_at=case['shape'],
            cases=[{k: c[k] for k in ('shape', 'dtype', 'layout')}
                   | {'ms': c['ms'][kernel],
                      'device_ms': c['device_ms'][kernel],
                      'bound_ms': c['bound_ms'][kernel],
                      'library_device_ms': c['library_device_ms'][
                          'fwd' if i == 0 else 'bwd']} for c in cases]))
    return rows


def main():
    card = phase_card()
    phase_build()
    cases = phase_kernel_vs_plain()
    bwd_cases, bwd_geometry = phase_backward_vs_plain()
    flash_cases = phase_flash_vs_plain()
    cfg = Config.fromfile(LEAF)
    model = init_segmentor(cfg)      # seeded random weights, on the card
    launches, _ = phase_serving(cfg, model)
    phase_card_vs_cpu(cfg, model)
    phase_pseudo_label(cfg, model, card)
    del model
    torch.cuda.empty_cache()
    train = phase_train(cfg, card)
    phase_train_card_vs_cpu(cfg)
    vit_cfg = vit_config()
    vit_model = init_segmentor(vit_cfg)      # seeded random weights
    vit_serve = phase_vit_serving(vit_cfg, vit_model)
    del vit_model
    torch.cuda.empty_cache()
    phase_vit_card_vs_cpu()
    vit_train = phase_vit_train(card)
    phase_vit_train_card_vs_cpu()
    phase_microbench()
    loop = phase_loop(card, train['fp32'][0])
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
        launches=launches + train_fwd + vit_serve['sim']
        + loop['launches'][0] + loop['launches_b'][0],
        launches_per_request=(launches + vit_serve['sim'])
        / (N_REQUESTS + N_VIT_REQUESTS),
        launches_per_train_step=train_fwd / (TRAIN_STEPS * len(train)),
        launches_per_loop_iter=loop['launches'][0] / LOOP_ITERS,
        max_abs_err=max(c['max_abs_err'] for c in cases),
        ms=main_case['ms'], device_ms=main_case['device_ms'],
        plain_ms=main_case['plain_ms'],
        bound_ms=main_case['bound_ms'], bound_by=main_case['bound_by'],
        library_ms=None, cases=cases), dict(
        name='neighborhood_similarity_backward', route='cuda',
        source='pfst_tpu_torch/ops/csrc/neighborhood_sim.cu',
        replaces='pfst_tpu/ops/pallas_sim.py:112',
        launches=train_bwd + loop['launches'][1] + loop['launches_b'][1],
        launches_per_request=0,
        launches_per_train_step=train_bwd / (TRAIN_STEPS * len(train)),
        launches_per_loop_iter=loop['launches'][1] / LOOP_ITERS,
        max_abs_err=max(c['max_abs_err'] for c in bwd_cases + bwd_geometry),
        ms=bwd_case['ms'], device_ms=bwd_case['device_ms'],
        plain_ms=bwd_case['plain_ms'],
        bound_ms=bwd_case['bound_ms'], bound_by=bwd_case['bound_by'],
        library_ms=None, cases=bwd_cases, geometry_cases=bwd_geometry)]
    kernels += _flash_entries(flash_cases, vit_serve, vit_train)
    log(f'[train] s/iter batch 2 of {TRAIN_HW}: fp32 {train["fp32"][0]:.4f}, '
        f'bf16 {train["bf16"][0]:.4f} on {card}')
    log(f'[vit] warm ms per {VIT_HW} request {vit_serve["warm_ms"]:.2f}; '
        f's/iter batch 2 of {VIT_HW}: fp32 {vit_train["fp32"][0]:.4f}, '
        f'bf16 {vit_train["bf16"][0]:.4f} on {card}')
    log(f'[loop] s/iter batch 2 of {TRAIN_HW} through the loop: median '
        f'{loop["s_iter_median"]:.4f} (bare step '
        f'{loop["bare_step_s_iter"]:.4f}), data stall median '
        f'{loop["data_stall_median"]:.4f} on {card}')
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
