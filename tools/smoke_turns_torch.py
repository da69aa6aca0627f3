#!/usr/bin/env python
"""Run ``chip_smoke.py`` from several checkouts in turns on one card, to
compare two versions within one call (noise between calls and cards is
larger than most changes).

Each run is its own process, ``python3 chip_smoke.py`` started in its
checkout's directory (which builds its kernels into its own ``build/``).
Each run's output goes to ``<out>/<i>_<label>.log`` (``--out``, by default
``build/smoke_turns``), and ``<out>/summary.json`` collects one line per
run, as printed: its exit code and the end-to-end numbers: ms per
DeepLabV3+ request (warm requests 3-6), the PFGST step's s/iter and
per-step times past warm-up (fp32, bf16) with, where the checkout's
phase 7 prints them, its host enqueue ms per step past warm-up, its
allocator retries and garbage collections, the ViT request's warm ms and
the ViT step's s/iter, and the similarity kernels' device ms per case
from the kernels line. For example, with the parent unpacked by ``git
archive`` into a gitignored directory::

    python3 tools/smoke_turns_torch.py parent=build/parent change=. \\
        change=. parent=build/parent [--out DIR]

Exits 1 if a run fails.
"""
import argparse
import json
import os
import os.path as osp
import re
import subprocess
import sys

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
OUT = osp.join(ROOT, 'build', 'smoke_turns')


def floats(text):
    return [float(v) for v in text.split(',')]


def numbers(text):
    """The end-to-end numbers of one run's output."""
    out = {}
    serve = re.search(r'\[serve\] .*?ms per request \[([^\]]*)\]', text)
    if serve:
        out['request_ms'] = floats(serve.group(1))[2:]
    for name in ('fp32', 'bf16'):
        train = re.search(rf'\[train {name}\] .*?s/iter \[([^\]]*)\], median '
                          rf'after (\d+) warm-ups ([\d.]+).*', text)
        if not train:
            continue
        warm = int(train.group(2))
        out[f'pfgst_{name}_s'] = float(train.group(3))
        out[f'pfgst_{name}_steps'] = floats(train.group(1))[warm:]
        host = re.search(r'host enqueue ms \[([^\]]*)\]; allocator retries '
                         r'(\d+); garbage collections (\d+)', train.group(0))
        if host:
            out[f'pfgst_{name}_enqueue_ms'] = floats(host.group(1))[warm:]
            out[f'pfgst_{name}_retries'] = int(host.group(2))
            out[f'pfgst_{name}_collections'] = int(host.group(3))
    vit = re.search(r'\[vit\] warm ms per \S+ \S+ request ([\d.]+); s/iter '
                    r'.*?fp32 ([\d.]+), bf16 ([\d.]+)', text)
    if vit:
        out['vit_request_ms'] = float(vit.group(1))
        out['vit_step_s'] = [float(vit.group(2)), float(vit.group(3))]
    for line in text.splitlines():
        if line.startswith('{"kernels"'):
            for k in json.loads(line)['kernels']:
                if k['name'].startswith('neighborhood_similarity'):
                    out[f'{k["name"]}_device_ms'] = {
                        f'{c["shape"]} {c["sim_type"]} {c["dtype"]}':
                        c['device_ms'] for c in k['cases']}
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('runs', nargs='+', metavar='label=checkout')
    parser.add_argument('--out', default=OUT)
    args = parser.parse_args(argv)
    runs = [arg.split('=', 1) for arg in args.runs]
    os.makedirs(args.out, exist_ok=True)
    ok = True
    rows = []
    for i, (label, path) in enumerate(runs):
        proc = subprocess.run([sys.executable, 'chip_smoke.py'],
                              cwd=osp.join(ROOT, path), capture_output=True,
                              text=True)
        text = proc.stdout + proc.stderr
        with open(osp.join(args.out, f'{i}_{label}.log'), 'w') as f:
            f.write(text)
        ok = ok and proc.returncode == 0
        last = proc.stdout.strip().splitlines()[-1:] or ['']
        rows.append(dict(run=i, label=label, rc=proc.returncode,
                         last_line=last[0], **numbers(text)))
        print(json.dumps(rows[-1]), flush=True)
    with open(osp.join(args.out, 'summary.json'), 'w') as f:
        json.dump(rows, f, indent=1)
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
