#!/usr/bin/env python
"""Short first check of the kernels on a card: build
``pfst_tpu_torch/ops/csrc/flash_attention.cu`` and ``neighborhood_sim.cu``
with ``nvcc -Xptxas -v`` (registers and spills of every instantiation at
launch), count in each flash instantiation's SASS (``cuobjdump
--dump-sass``) the warpgroup products (``HGMMA``), the warp products
(``HMMA``), the registers it names (after ``setmaxnreg``: the highest
``R`` index + 1) and its ``SETMAXREG`` instructions, then run each flash
kernel once per case of ``chip_smoke.py``'s phase 3c (and at head
dimensions 32 and 128), the similarity forward once per case of its
phase 3 and the similarity backward once per path case of its phase 3b
(and both at d = 4 and an odd width, their general geometry), compare
each with the plain versions and print its median time, per call as
phases 3 and 3c time it (one launch between two CUDA events, the
wrapper's host path included) and on the device (``graph``:
``chip_smoke.graph_ms``, a CUDA graph of ten launches back to back, the
host path out of the way), beside SDPA's (flash) or the bound
(similarity).

For a first call after a kernel change, before ``chip_smoke.py``::

    python3 tools/flash_probe_torch.py

The errors and limits are ``chip_smoke.flash_errors``'s (phase 3c),
``chip_smoke.sim_errors``'s (phase 3) and ``chip_smoke.sim_bwd_errors``'s
(phase 3b). Exits 1 if a case fails, if a
``flash_*_wgmma_kernel`` instantiation (the bf16 forward and dK/dV, dQ
in both types, each with and without the bias ``ab``) has no HGMMA, or
if another flash instantiation (the fp32 forward and dK/dV) has no HMMA.
"""
import collections
import concurrent.futures
import itertools
import os.path as osp
import re
import statistics
import subprocess
import sys
import tempfile
import time

import torch
import torch.nn.functional as F

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))
from chip_smoke import (BWD_SHAPE, FLASH_CASES, SIGMA,  # noqa: E402
                        SIM_CASES, SIM_D, SIM_K, _flash_inputs,
                        flash_errors, graph_ms, sim_bound, sim_bwd_bound,
                        sim_bwd_errors, sim_errors)
from pfst_tpu_torch.ops import (build, cuda_flash_attention,  # noqa: E402
                                cuda_flash_attention_bwd_dkv,
                                cuda_flash_attention_bwd_dq,
                                cuda_neighborhood_similarity)

CASES = FLASH_CASES + [((2, 3, 130, 32), torch.bfloat16, 'qkv'),
                       ((2, 3, 130, 32), torch.float32, 'qkv'),
                       ((1, 2, 300, 128), torch.float32, 'qkv'),
                       ((1, 2, 300, 128), torch.bfloat16, 'contiguous')]


def kernel_name(mangled):
    """'flash_fwd_kernel fp32 D=64' ('... ab' for the instantiation with
    the bias; or 'neighborhood_sim_kernel bf16 K=3 cosine d=2', 'd=any'
    for the general geometry) from a mangled instantiation name; the
    forward and dK/dV wgmma kernels take bf16 only, and name no type."""
    kernel = re.search(r'(flash_\w+?|neighborhood_sim\w*?)_kernel', mangled)
    ints = re.findall(r'Li(\d+)E', mangled)
    arg = re.search(r'Li(\d+)E', mangled)
    bf16_only = re.search(r'flash_(fwd|bwd_dkv)_wgmma', mangled)
    dtype = 'bf16' if '__nv_bfloat16' in mangled or bf16_only else 'fp32'
    name = f'{kernel.group(0) if kernel else mangled} {dtype}'
    if kernel and kernel.group(0).startswith('flash'):
        bias = ' ab' if 'Lb1E' in mangled else ''
        return f'{name} D={arg.group(1) if arg else "?"}{bias}'
    cosine = 'cosine' if 'Lb1E' in mangled else 'gaussian'
    ds = f'd={ints[1]}' if len(ints) > 1 and ints[1] != '0' else 'd=any'
    return f'{name} K={arg.group(1) if arg else "?"} {cosine} {ds}'


def ptxas_report(source, out_dir):
    """Build ``source`` with ``-Xptxas -v`` into ``out_dir``; print each
    instantiation's registers, spills and ptxas warnings; return the
    library's path."""
    out = osp.join(out_dir, f'{osp.splitext(source)[0]}.so')
    # one compiler thread, so each entry's report follows its name
    flags = [f for f in build.NVCC_FLAGS
             if not f.startswith('--split-compile')]
    proc = subprocess.run(
        [build._nvcc(), *flags, '-Xptxas', '-v', '-o', out,
         osp.join(build.CSRC_DIR, source)], capture_output=True, text=True)
    print(f'ptxas {source} rc', proc.returncode)
    name = None
    for line in (proc.stdout + proc.stderr).splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            name = kernel_name(entry.group(1))
        elif ('registers' in line or 'spill' in line or 'error' in line
              or 'arning' in line):
            print(f'[{source}] {name}: {line.split(":", 1)[-1].strip()}')
    return out if proc.returncode == 0 else None


def sass_counts(lib_path):
    """Per kernel instantiation in the library's SASS: HGMMA and HMMA
    instructions, local-memory (spill) stores and loads, registers named
    (highest R index + 1) and the SETMAXREG instructions."""
    cuobjdump = osp.join(osp.dirname(build._nvcc()), 'cuobjdump')
    sass = subprocess.run([cuobjdump, '--dump-sass', lib_path],
                          capture_output=True, text=True, check=True).stdout
    counts = collections.defaultdict(lambda: dict(
        hgmma=0, hmma=0, spill=0, regs=0, setmaxreg=set()))
    name = None
    for line in sass.splitlines():
        fn = re.search(r'Function : (\S+)', line)
        if fn:
            name = kernel_name(fn.group(1))
            counts[name]['hgmma'] += 0
            continue
        if name is None or '/*' not in line:
            continue
        c = counts[name]
        c['hgmma'] += 'HGMMA' in line
        c['hmma'] += 'HMMA' in line
        c['spill'] += ' STL' in line or ' LDL' in line
        regs = [int(r) for r in re.findall(r'\bR(\d+)\b', line)]
        c['regs'] = max([c['regs'], *(r + 1 for r in regs)])
        if 'SETMAXREG' in line:
            c['setmaxreg'].add(line.split('*/', 1)[1].split(';')[0].strip())
    return counts


def check_sass(counts):
    """Print the counts; False unless every wgmma instantiation (bf16
    forward and dK/dV, dQ in both types: 12, each with and without the
    bias: 24) has HGMMA and every other flash instantiation (fp32 forward
    and dK/dV: 12 with the bias's) HMMA."""
    ok = len(counts) == 36
    for name, c in sorted(counts.items()):
        need = 'hgmma' if 'wgmma' in name else 'hmma'
        good = c[need] > 0
        ok = ok and good
        print(f'SASS {name}: HGMMA {c["hgmma"]} HMMA {c["hmma"]} '
              f'STL/LDL {c["spill"]} registers {c["regs"]} '
              f'{sorted(c["setmaxreg"])}'
              f'{"" if good else " FAIL: no " + need.upper()}')
    if len(counts) != 36:
        print(f'FAIL: {len(counts)} flash instantiations, not 36')
    return ok


def cuda_ms(fn, reps=10):
    fn()
    torch.cuda.synchronize()
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


def check(shape, dtype, layout, gen, nk=None):
    b, h, n, d = shape
    q, k, v = _flash_inputs(shape, dtype, layout, gen, nk)
    g = torch.randn(shape, generator=gen).to('cuda', dtype)
    s = d**-0.5
    o, lse, err = flash_errors(q, k, v, g, s)
    di = (o.float() * g.float()).sum(-1).contiguous()
    t_fwd = cuda_ms(lambda: cuda_flash_attention(q, k, v, s))
    t_dkv = cuda_ms(lambda: cuda_flash_attention_bwd_dkv(q, k, v, g, lse, di,
                                                         s))
    t_dq = cuda_ms(lambda: cuda_flash_attention_bwd_dq(q, k, v, g, lse, di,
                                                       s))
    graph = [graph_ms(lambda: cuda_flash_attention(q, k, v, s)),
             graph_ms(lambda: cuda_flash_attention_bwd_dkv(q, k, v, g, lse,
                                                           di, s)),
             graph_ms(lambda: cuda_flash_attention_bwd_dq(q, k, v, g, lse,
                                                          di, s)),
             graph_ms(lambda: F.scaled_dot_product_attention(q, k, v,
                                                             scale=s))]
    flops = 4 * b * h * n * k.shape[2] * d
    print(f'{shape} N_k {k.shape[2]} {dtype} {layout}: fwd excess {err["fwd_excess"]:.2e} '
          f'(limit {err["fwd_limit"]:.1e}) lse {err["lse_err"]:.2e}; '
          f'bwd excess {err["bwd_excess"]:.2e} (limit '
          f'{err["bwd_limit"]:.1e}) {"OK" if err["ok"] else "FAIL"}; ms fwd '
          f'{t_fwd:.4f} ({flops / t_fwd / 1e9:.1f} TFLOP/s) dkv {t_dkv:.4f} '
          f'({1.5 * flops / t_dkv / 1e9:.1f}) dq {t_dq:.4f} '
          f'({flops / t_dq / 1e9:.1f}); graph ms fwd '
          f'{graph[0]:.4f} dkv {graph[1]:.4f} dq {graph[2]:.4f} SDPA fwd '
          f'{graph[3]:.4f}', flush=True)
    return err['ok']


def check_sim(shape, sim_type, dtype, gen, dilation=SIM_D):
    """The similarity forward at one of phase 3's cases (or at another
    dilation, which takes the kernel's general geometry): error, time per
    call and on the device, against its bound."""
    x = torch.randn(shape, generator=gen).to('cuda', dtype)
    cosine = sim_type == 'cosine'

    def kernel():
        return cuda_neighborhood_similarity(x, SIM_K, dilation, sim_type,
                                            SIGMA, with_norms=cosine)
    err = sim_errors(x, SIM_K, dilation, sim_type)
    t_call = cuda_ms(kernel, 30)
    t_graph = graph_ms(kernel)
    bound, bound_by = sim_bound(shape, dtype, sim_type)
    print(f'similarity {shape} d{dilation} {sim_type} {dtype}: max_abs_err '
          f'{err["max_abs_err"]:.2e} norm_rel_err {err["norm_rel_err"]:.2e} '
          f'{"OK" if err["ok"] else "FAIL"}; ms {t_call:.4f}, graph ms '
          f'{t_graph:.4f}, bound {bound:.4f} ({bound_by}), graph / bound '
          f'{t_graph / bound:.2f}', flush=True)
    return err['ok']


def check_sim_bwd(shape, sim_type, dtype, gen, dilation=SIM_D):
    """The similarity backward at the training shape (or at another
    dilation or width, which take its general geometry): error against
    autograd and the plain gather backward, repeat launches bitwise
    equal, time per call and on the device, against its bound."""
    x = torch.randn(shape, generator=gen).to('cuda', dtype)
    g = torch.randn((shape[0], SIM_K**2, *shape[2:]), generator=gen).cuda()
    err, fns = sim_bwd_errors(x, g, SIM_K, dilation, sim_type)
    t_call = cuda_ms(fns['kernel'], 30)
    t_graph = graph_ms(fns['kernel'])
    bound, bound_by = sim_bwd_bound(shape, dtype, sim_type)
    print(f'similarity backward {shape} d{dilation} {sim_type} {dtype}: '
          f'max_abs_err {err["max_abs_err"]:.2e} beyond rounding '
          f'{err["err_beyond_rounding"]:.2e} (limit {err["limit"]:.1e}) '
          f'repeat bitwise equal {err["repeat_bitwise_equal"]} '
          f'{"OK" if err["ok"] else "FAIL"}; ms {t_call:.4f}, graph ms '
          f'{t_graph:.4f}, bound {bound:.4f} ({bound_by}), graph / bound '
          f'{t_graph / bound:.2f}', flush=True)
    return err['ok']


def first_launches():
    """Each wgmma flash kernel (and the fp32 forward and dK/dV) once alone
    at every head dimension, with a synchronize after it, so that a fault
    names its kernel; exits 1 at the first fault (the context is lost with
    it)."""
    gen = torch.Generator().manual_seed(5)
    for dtype, d in itertools.product((torch.bfloat16, torch.float32),
                                      (32, 64, 128)):
        shape = (1, 2, 130, d)
        q, k, v, g = (torch.randn(shape, generator=gen).to('cuda', dtype)
                      for _ in range(4))
        s = d**-0.5
        name = 'forward'
        try:
            o, lse = cuda_flash_attention(q, k, v, s)
            torch.cuda.synchronize()
            di = (o.float() * g.float()).sum(-1).contiguous()
            name = 'dK/dV'
            cuda_flash_attention_bwd_dkv(q, k, v, g, lse, di, s)
            torch.cuda.synchronize()
            name = 'dQ'
            cuda_flash_attention_bwd_dq(q, k, v, g, lse, di, s)
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001 - name the kernel, stop
            print(f'FAIL first launch of the {dtype} {name} kernel at '
                  f'{shape}: {e}', flush=True)
            sys.exit(1)
        print(f'first launches {shape} {dtype}: forward, dK/dV, dQ ran',
              flush=True)


def main():
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip())
    print(torch.__version__, torch.version.cuda)
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp, \
            concurrent.futures.ThreadPoolExecutor(4) as pool:
        jobs = [pool.submit(ptxas_report, 'flash_attention.cu', tmp),
                pool.submit(ptxas_report, 'neighborhood_sim.cu', tmp),
                pool.submit(build.build, 'flash_attention'),
                pool.submit(build.build, 'neighborhood_sim')]
        paths = [j.result() for j in jobs]
        print(f'four nvcc builds at once {time.time() - t0:.1f}s')
        ok = None not in paths
        if ok:
            ok = check_sass(sass_counts(paths[2]))
            build.load('flash_attention')
        build.load('neighborhood_sim')
        first_launches()
        gen = torch.Generator().manual_seed(4)
        for shape, sim_type in SIM_CASES:
            for dtype in (torch.float32, torch.bfloat16):
                ok = check_sim(shape, sim_type, dtype, gen) and ok
        # the general geometry: the pfst base config's dilation, and an
        # odd width (4-byte copies, plain loads for bf16)
        for shape, dilation in (((2, 512, 64, 64), 4),
                                ((1, 256, 63, 99), 2)):
            for dtype in (torch.float32, torch.bfloat16):
                ok = check_sim(shape, 'cosine', dtype, gen, dilation) and ok
        for sim_type, dtype in itertools.product(
                ('cosine', 'gaussian'), (torch.float32, torch.bfloat16)):
            ok = check_sim_bwd(BWD_SHAPE, sim_type, dtype, gen) and ok
            for shape, dilation in (((2, 512, 64, 64), 4),
                                    ((1, 256, 63, 99), 2)):
                ok = check_sim_bwd(shape, sim_type, dtype, gen,
                                   dilation) and ok
        for case in CASES:
            ok = check(*case[:3], gen, *case[3:]) and ok
            torch.cuda.empty_cache()
    sys.exit(0 if ok else 1)


if __name__ == '__main__':
    main()
