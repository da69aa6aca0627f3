#!/usr/bin/env python
"""Time variants of the flash dQ kernel on a card, for design work on
``pfst_tpu_torch/ops/csrc/flash_attention.cu``.

Each variant is a copy of the package (and of ``chip_smoke.py``) under
``build/flash_variants/<name>/`` (``sim_variants_torch.prepare``) with
one of the dQ kernel's constants changed: ``dq_wg=N`` consumer
warpgroups a block for bf16 (``kDqWG``), ``dq_wg32=N`` for fp32 at
D <= 64 (``kDqWG32``), ``dq_stages=N`` the most ring stages (where they
fit); join several with ``+``. Or with a part of the kernel taken out to
see what it costs (the results are then wrong): ``no-split`` leaves
fp32's K and V tiles unsplit (the split warps only arrive), ``no-lo``
takes S and dP as one TF32 product of the hi parts, ``no-dq`` drops the
dQ product (and with it the arithmetic that only feeds it). Every
variant is built first, all ``nvcc`` runs at once; each then runs in its
own process and prints, per case of ``chip_smoke.py``'s phase 3c, its
agreement with the plain versions (``chip_smoke.flash_errors``) and dQ's
device time (``chip_smoke.graph_ms``: ten launches a graph). ``--rounds
2`` runs the list twice, in turn::

    python3 tools/flash_variants_torch.py --variants base,dq_wg=2
"""
import argparse
import concurrent.futures
import functools
import os.path as osp
import subprocess
import sys

from sim_variants_torch import ROOT, build, prepare

OUT = osp.join(ROOT, 'build', 'flash_variants')
SOURCE = ('pfst_tpu_torch', 'ops', 'csrc', 'flash_attention.cu')
CONSTANTS = {'dq_wg': r'(constexpr int kDqWG = )\d+',
             'dq_wg32': r'(kDqWG32 = )\d+',
             'dq_stages': r'(kMaxStages = )\d+'}

# literal edits of the parts
SPLIT = """          split_keys<D, KT>(t.k, t.k_lo, t.kt_hi, t.kt_lo, i0);
          split_tile(t.v, t.v_lo, L::kKeyTile, i0);
"""
LO = ('      pfst::wgmma_rs_tf32<KT>({0}, {1}l[kk], {2}, kk > 0);\n'
      '      pfst::wgmma_ss_tf32<KT>({0}, {1}, pfst::desc_k<T, D, KT>'
      '(t.{2}_lo, 0, kk),\n                              1);\n'
      '      pfst::wgmma_ss_tf32<KT>({0}, {1}, {2}, 1);')
DQ = '    for (int kc = 0; kc < PS; ++kc) {\n      if constexpr (kSplit) {\n' \
     '        const uint64_t hi'
PARTS = {'no-split': [(SPLIT, '')],
         'no-lo': [(LO.format(a, b, c),
                    f'      pfst::wgmma_ss_tf32<KT>({a}, {b}, {c}, kk > 0);')
                   for a, b, c in (('sc', 'q', 'k'), ('dp', 'o', 'v'))],
         'no-dq': [(DQ, DQ.replace('kc < PS', 'kc < 0'))]}

CHILD = r'''
import sys
import torch
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
from pfst_tpu_torch.ops import cuda_flash_attention_bwd_dq
gen = torch.Generator().manual_seed(4)
for shape, dtype, layout, *nk in cs.FLASH_CASES:
    nk = nk[0] if nk else None
    q, k, v = cs._flash_inputs(shape, dtype, layout, gen, nk)
    g = torch.randn(shape, generator=gen).to('cuda', dtype)
    s = shape[-1]**-0.5
    o, lse, err = cs.flash_errors(q, k, v, g, s)
    di = (o.float() * g.float()).sum(-1).contiguous()
    ms = cs.graph_ms(lambda: cuda_flash_attention_bwd_dq(q, k, v, g, lse,
                                                         di, s))
    bound = cs.flash_bounds(shape, dtype, nk=nk)['dq'][0]
    print(f'{sys.argv[2]} {shape} N_k {k.shape[2]} {str(dtype)[6:]} {layout} '
          f'ok {err["ok"]} '
          f'dq_err {err["dq_err"]:.2e} dQ device ms {ms:.4f} bound '
          f'{bound:.4f} x{ms / bound:.2f}', flush=True)
    del q, k, v, g, o, lse, di
    torch.cuda.empty_cache()
'''


def edits(name):
    """(pattern, replacement, is_regex) edits of the source for a variant."""
    out = []
    for part in [] if name == 'base' else name.split('+'):
        if part in PARTS:
            out += [(a, b, False) for a, b in PARTS[part]]
        else:
            key, value = part.split('=')
            out.append((CONSTANTS[key], rf'\g<1>{int(value)}', True))
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--variants', default='base,dq_wg=2')
    parser.add_argument('--rounds', type=int, default=1)
    args = parser.parse_args(argv)
    names = args.variants.split(',')
    dirs = [prepare(name, OUT, SOURCE, edits) for name in names]
    with concurrent.futures.ThreadPoolExecutor(len(dirs)) as pool:
        list(pool.map(functools.partial(build, library='flash_attention'),
                      dirs))
    for r in range(args.rounds):
        for name, d in zip(names, dirs):
            subprocess.run([sys.executable, '-c', CHILD, d, f'{name}#{r}'],
                           check=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
