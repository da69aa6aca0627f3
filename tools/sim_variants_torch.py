#!/usr/bin/env python
"""Time variants of the similarity forward kernel on a card, for design
work on ``pfst_tpu_torch/ops/csrc/neighborhood_sim.cu``.

Each variant is a copy of the package (and of ``chip_smoke.py``) under
``build/sim_variants/<name>/`` with the kernel's tuning constants changed
(warps a block, stages of a warp's ring, channels a stage), or with a part
of the kernel taken out to see what the rest costs: ``no-arith`` keeps the
copies and drops the arithmetic, ``no-copies`` the reverse (its results
are garbage), ``empty`` drops both. Every variant is built first, all
``nvcc`` runs at once; each then runs in its own process (its own
package and build directory) and prints, per phase-3 case of
``chip_smoke.py``, its agreement with the plain version
(``chip_smoke.sim_errors``), its device time (``chip_smoke.graph_ms``:
ten launches a graph) and one-launch graph replay, and the ratio to
``chip_smoke.sim_bound``. ``--rounds 2`` runs the list twice, in turn::

    python3 tools/sim_variants_torch.py --variants base,no-arith,no-copies
    python3 tools/sim_variants_torch.py --variants base,stages=3,group=2

A variant ``name=value`` sets one constant: ``warps`` (for k = 3),
``stages`` or ``group`` (channels a stage at d = 2); join several with
``+`` (``stages=3+group=2``).
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
CONSTANTS = {
    'warps': (r'return K == 3 \? \d+ : 8;', 'return K == 3 ? {} : 8;'),
    'stages': (r'constexpr int kStages = \d+;', 'constexpr int kStages = {};'),
    'group': (r'constexpr int kFixedGroup = \d+;',
              'constexpr int kFixedGroup = {};'),
}
# the arithmetic loop and the compile-time path's copies
ARITH = '    for (int g = 0; g < group; ++g) {'
COPIES = 'pfst::cp_async16(dst + doff[m], ok ? xc + soff[m] : x, ok);'
PARTS = {'no-arith': [(ARITH, ARITH.replace('g < group', 'g < 0'))],
         'no-copies': [(COPIES, '')]}
PARTS['empty'] = PARTS['no-arith'] + PARTS['no-copies']

CHILD = r'''
import sys
import torch
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
from pfst_tpu_torch.ops import cuda_neighborhood_similarity
gen = torch.Generator().manual_seed(4)
for shape, sim_type in cs.SIM_CASES:
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(shape, generator=gen).to('cuda', dtype)
        cosine = sim_type == 'cosine'
        def kernel():
            return cuda_neighborhood_similarity(x, cs.SIM_K, cs.SIM_D,
                                                sim_type, cs.SIGMA,
                                                with_norms=cosine)
        ok = cs.sim_errors(x, cs.SIM_K, cs.SIM_D, sim_type)['ok']
        ms = cs.graph_ms(kernel)
        one = cs.graph_ms(kernel, reps=100, calls=1)
        bound, _ = cs.sim_bound(shape, dtype, sim_type)
        print(f'{sys.argv[2]} {shape} {sim_type} {str(dtype)[6:]} ok {ok} '
              f'device ms {ms:.4f} one-launch replay {one:.4f} bound '
              f'{bound:.4f} x{ms / bound:.2f}', flush=True)
'''


def edits(name):
    """(pattern, replacement, is_regex) edits of the source for a variant."""
    if name == 'base':
        return []
    if name in PARTS:
        return [(a, b, False) for a, b in PARTS[name]]
    out = []
    for part in name.split('+'):
        key, value = part.split('=')
        pattern, template = CONSTANTS[key]
        out.append((pattern, template.format(int(value)), True))
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
    args = parser.parse_args(argv)
    names = args.variants.split(',')
    dirs = [prepare(name) for name in names]
    with concurrent.futures.ThreadPoolExecutor(len(dirs)) as pool:
        list(pool.map(build, dirs))
    for r in range(args.rounds):
        for name, d in zip(names, dirs):
            subprocess.run([sys.executable, '-c', CHILD, d, f'{name}#{r}'],
                           check=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
