#!/usr/bin/env python
"""Time variants of the similarity kernels, forward and backward, on a
card, for design work on ``pfst_tpu_torch/ops/csrc/neighborhood_sim.cu``.

Each variant is a copy of the package (and of ``chip_smoke.py``) under
``build/sim_variants/<name>/`` with the kernels' tuning constants changed,
or with a part of the kernels taken out to see what the rest costs (their
results are then wrong): ``no-arith`` drops each channel's work on a
staged stage (the forward's partial sums; the backward's weighted sums
and its stores), so the copies are left; ``no-taps`` replaces every read
of a staged tap by 0 (the backward keeps its stores of grad_x);
``no-copies`` drops the compile-time geometry's ``cp.async`` copies;
``empty`` is ``no-arith`` and ``no-copies``. Every variant is built first,
all ``nvcc`` runs at once; each then runs in its own process (its own
package and build directory) and prints, per phase-3 case of
``chip_smoke.py`` (forward) and per phase-3b path case (backward, the
training shape), its agreement with the plain versions
(``chip_smoke.sim_errors``, ``chip_smoke.sim_bwd_errors``), its device
time (``chip_smoke.graph_ms``: ten launches a graph) and one-launch graph
replay, and the ratio to the bound. ``--rounds 2`` runs the list twice,
in turn; ``--kernels bwd`` times the backward only::

    python3 tools/sim_variants_torch.py --variants base,no-arith,no-copies
    python3 tools/sim_variants_torch.py --kernels bwd \
        --variants base,bwd_warps=8,bwd_stages=3

A variant ``name=value`` sets one constant: the forward's ``warps`` (for
k = 3), ``stages`` or ``group`` (channels a stage at d = 2); the
backward's ``bwd_warps`` (for k = 3), ``bwd_stages`` or ``bwd_group``;
join several with ``+`` (``bwd_stages=3+bwd_group=2``).
"""
import argparse
import concurrent.futures
import os
import os.path as osp
import re
import shutil
import subprocess
import sys

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
OUT = osp.join(ROOT, 'build', 'sim_variants')
SOURCE = ('pfst_tpu_torch', 'ops', 'csrc', 'neighborhood_sim.cu')
# name: the text before the constant's value
CONSTANTS = {
    'warps': r'(fwd_warps\(\) \{\s+return K == 3 \? )\w+',
    'stages': r'(constexpr int kStages = )\w+',
    'group': r'(constexpr int kFixedGroup = )\w+',
    'bwd_warps': r'(bwd_warps\(\) \{\s+return K == 3 \? )\w+',
    'bwd_stages': r'(constexpr int kBwdStages = )\w+',
    'bwd_group': r'(constexpr int kBwdGroup = )\w+',
}
# each channel's work on a stage, a read of a staged tap, and the
# compile-time geometry's copies
ARITH = 'body(buf + g * st.slot, c0 + it * st.group + g);'
TAP = r'widen\(rows\[[^\]]*\]\)'
COPIES = 'pfst::cp_async16(dst + doff[m], ok ? xc + soff[m] : x, ok);'
PARTS = {'no-arith': [(ARITH, ';', False)], 'no-taps': [(TAP, '0.f', True)],
         'no-copies': [(COPIES, '', False)]}
PARTS['empty'] = PARTS['no-arith'] + PARTS['no-copies']

CHILD = r'''
import sys
import torch
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
from pfst_tpu_torch.ops import cuda_neighborhood_similarity
gen = torch.Generator().manual_seed(4)
name, kernels, check = sys.argv[2], sys.argv[3].split(','), sys.argv[4]
failed = 0


def report(what, fn, ok, bound):
    global failed
    failed += not ok
    ms = cs.graph_ms(fn)
    one = cs.graph_ms(fn, reps=100, calls=1)
    print(f'{name} {what} ok {ok} device ms {ms:.4f} one-launch replay '
          f'{one:.4f} bound {bound:.4f} x{ms / bound:.2f}', flush=True)


for shape, sim_type in cs.SIM_CASES if 'fwd' in kernels else ():
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(shape, generator=gen).to('cuda', dtype)
        cosine = sim_type == 'cosine'
        def kernel():
            return cuda_neighborhood_similarity(x, cs.SIM_K, cs.SIM_D,
                                                sim_type, cs.SIGMA,
                                                with_norms=cosine)
        ok = cs.sim_errors(x, cs.SIM_K, cs.SIM_D, sim_type)['ok']
        report(f'forward {shape} {sim_type} {str(dtype)[6:]}', kernel, ok,
               cs.sim_bound(shape, dtype, sim_type)[0])
b, _, h, w = cs.BWD_SHAPE
for sim_type in ('cosine', 'gaussian') if 'bwd' in kernels else ():
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(cs.BWD_SHAPE, generator=gen).to('cuda', dtype)
        g = torch.randn((b, cs.SIM_K**2, h, w), generator=gen).cuda()
        err, fns = cs.sim_bwd_errors(x, g, cs.SIM_K, cs.SIM_D, sim_type)
        report(f'backward {cs.BWD_SHAPE} {sim_type} {str(dtype)[6:]}',
               fns['kernel'], err['ok'],
               cs.sim_bwd_bound(cs.BWD_SHAPE, dtype, sim_type)[0])
# a variant with a part taken out is wrong by design
sys.exit(1 if failed and check == 'check' else 0)
'''


def edits(name):
    """(pattern, replacement, is_regex) edits of the source for a variant."""
    if name == 'base':
        return []
    if name in PARTS:
        return PARTS[name]
    out = []
    for part in name.split('+'):
        key, value = part.split('=')
        out.append((CONSTANTS[key], rf'\g<1>{int(value)}', True))
    return out


def prepare(name, out=OUT, source=SOURCE, edits=edits):
    """The variant's directory under ``out``: a copy of the package with
    the variant's ``edits`` made to its ``source``."""
    d = osp.join(out, name.replace('=', '_').replace('+', '__'))
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(osp.join(ROOT, 'pfst_tpu_torch'),
                    osp.join(d, 'pfst_tpu_torch'),
                    ignore=shutil.ignore_patterns('__pycache__'))
    shutil.copy(osp.join(ROOT, 'chip_smoke.py'), d)
    path = osp.join(d, *source)
    with open(path) as f:
        src = f.read()
    for pattern, replacement, is_regex in edits(name):
        new = (re.sub(pattern, replacement, src) if is_regex
               else src.replace(pattern, replacement))
        if new == src:
            raise RuntimeError(f'{name}: {pattern!r} not found in the source')
        src = new
    with open(path, 'w') as f:
        f.write(src)
    return d


def build(d, library='neighborhood_sim'):
    code = (f'import sys; sys.path.insert(0, {d!r}); '
            'from pfst_tpu_torch.ops import build; '
            f'build.build({library!r})')
    subprocess.run([sys.executable, '-c', code], check=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--variants', default='base,no-arith,no-copies,empty')
    parser.add_argument('--rounds', type=int, default=1)
    parser.add_argument('--kernels', default='fwd,bwd',
                        help='fwd, bwd or both, comma-separated')
    args = parser.parse_args(argv)
    names = args.variants.split(',')
    dirs = [prepare(name) for name in names]
    with concurrent.futures.ThreadPoolExecutor(len(dirs)) as pool:
        list(pool.map(build, dirs))
    ok = True
    for r in range(args.rounds):
        for name, d in zip(names, dirs):
            check = 'no' if name in PARTS else 'check'
            ok = subprocess.run([sys.executable, '-c', CHILD, d,
                                 f'{name}#{r}', args.kernels,
                                 check]).returncode == 0 and ok
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
