"""The ranks of ``tests/test_torch_ddp.py``: a process group of the port
on the CPU, without JAX.

``start_ranks(job, directory)`` starts ``world`` processes of this file;
each joins a gloo group through a file store in ``directory``, takes its
share of each task of ``job`` (a dict of task dicts, saved with
``torch.save``), runs it on its rank and saves its results to
``rank<r>.pt``; ``join_ranks`` waits for them, with a time limit, and
returns every rank's results. The test module's JAX never reaches these
processes: they import this file, not the test module.
"""
from __future__ import annotations

import copy
import datetime
import os
import os.path as osp
import subprocess
import sys

import numpy as np
import torch

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
JOIN_SECONDS = 120
MEAN = [123.675, 116.28, 103.53]
STD = [58.395, 57.12, 57.375]


def start_ranks(job: dict, directory: str, world: int = 2):
    """Start the ``world`` rank processes of ``job`` in ``directory``."""
    job_path = osp.join(directory, 'job.pt')
    torch.save(job, job_path)
    env = dict(os.environ, OMP_NUM_THREADS='1', PYTHONPATH=os.pathsep.join(
        [REPO, os.environ.get('PYTHONPATH', '')]))
    return [subprocess.Popen(
        [sys.executable, osp.abspath(__file__), str(r), str(world),
         osp.join(directory, 'store'), job_path, directory],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


def join_ranks(procs, directory: str, timeout: float = JOIN_SECONDS):
    """Each rank's results, in rank order; a rank that fails, or that is
    not done within ``timeout`` seconds, fails the caller with its
    output (and the others are killed)."""
    try:
        for r, p in enumerate(procs):
            out, _ = p.communicate(timeout=timeout)
            if p.returncode != 0:
                raise RuntimeError(f'rank {r} exited {p.returncode}:\n{out}')
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [torch.load(osp.join(directory, f'rank{r}.pt'),
                       weights_only=False) for r in range(len(procs))]


def shard(x, rank: int, world: int):
    """Rank ``rank``'s equal share of ``x`` along dim 0."""
    n = x.shape[0] // world
    return x[rank * n:(rank + 1) * n]


class ToyDataset:
    """Images and labels from a seed, with the dataset API that
    ``single_gpu_test`` / ``multi_gpu_test`` read: ``__getitem__`` gives a
    sample's normalized CHW view and metas, ``pre_eval`` its histograms."""

    def __init__(self, n: int, size: int, num_classes: int, seed: int = 0):
        rs = np.random.RandomState(seed)
        self.imgs = rs.randn(n, 3, size, size).astype(np.float32)
        self.gts = rs.randint(0, num_classes, (n, size, size))
        self.num_classes = num_classes

    def __len__(self):
        return len(self.imgs)

    def __getitem__(self, i):
        h, w = self.imgs.shape[2:]
        return {'img': self.imgs[i],
                'img_metas': {'ori_shape': (h, w, 3), 'flip': False}}

    def pre_eval(self, pred, idx):
        from pfst_tpu_torch.core.evaluation.metrics import \
            intersect_and_union
        return [intersect_and_union(pred, self.gts[idx], self.num_classes,
                                    255)]


class ToyLoader:
    def __init__(self, dataset):
        self.dataset = dataset


def bn_counts(module):
    """The number of values each BN normalizes over, recorded by forward
    hooks (for the n/(n-1) gap of torch's running variance)."""
    counts = {}
    hooks = [m.register_forward_hook(
        lambda mod, inp, out, name=n: counts.__setitem__(
            name, inp[0].numel() // inp[0].shape[1]))
        for n, m in module.named_modules()
        if isinstance(m, torch.nn.BatchNorm2d)]
    return counts, hooks


def train_state(task):
    """The task's algorithm and train state on the CPU: the modules of
    ``task['state']`` loaded into the algorithm of ``task['cfg']``."""
    from pfst_tpu_torch.apis import build_algorithm
    from pfst_tpu_torch.core import build_optimizers
    algo = build_algorithm(copy.deepcopy(task['cfg']), device='cpu')
    state = algo.init_state(torch.Generator().manual_seed(0),
                            build_optimizers(task['opt']))
    for name, sd in task['state'].items():
        getattr(state, name).load_state_dict(sd)
    state.step = task['step']
    return algo, state


def run_step(task, rank, world, group):
    """One train step over ``group`` of rank ``rank``'s shard of the batch
    (and of the premix) in a world of ``world``: the log vars, every
    module's state dict and the BN counts."""
    algo, state = train_state(task)
    batch = {k: shard(v, rank, world) for k, v in task['batch'].items()}
    kwargs = {}
    if task.get('premix') is not None:
        kwargs['premix'] = task['premix'][rank]
    counts, hooks = bn_counts(state.student)
    state, log_vars = algo.make_train_step(MEAN, STD, group=group)(
        state, batch, torch.Generator().manual_seed(task['gen_seed'] + rank),
        **kwargs)
    for h in hooks:
        h.remove()
    return dict(log_vars={k: v.item() for k, v in log_vars.items()},
                modules={n: copy.deepcopy(getattr(state, n).state_dict())
                         for n in task['state']},
                counts=counts, step=state.step)


def task_step(task, rank, world, groups):
    out = run_step(task, rank, world, groups['world'])
    if task.get('single') and rank == 0:
        # world size 1: rank 0's shard stepped over a group of one rank,
        # and with no group, bitwise
        one = run_step(task, 0, world, groups['single'])
        alone = run_step(task, 0, world, None)
        out['single'] = dict(
            log_vars=one['log_vars'] == alone['log_vars'],
            modules=all(torch.equal(one['modules'][n][k], v)
                        for n, sd in alone['modules'].items()
                        for k, v in sd.items()))
    return out


def task_sync_bn(task, rank, world, groups):
    """``SyncBN`` in train mode on this rank's shard inside the group:
    its output, the gradients of ``sum(y * g)``, the running statistics."""
    from pfst_tpu_torch.models.utils.layers import Norm
    from pfst_tpu_torch.parallel import sync_bn_group
    bn = Norm(task['x'].shape[1], dict(type='SyncBN')).train()
    bn.load_state_dict(task['bn'])
    x = shard(task['x'], rank, world).clone().requires_grad_()
    with sync_bn_group(groups['world']):
        y = bn(x)
    (y * shard(task['g'], rank, world)).sum().backward()
    return dict(y=y.detach(), dx=x.grad, dw=bn.weight.grad,
                db=bn.bias.grad, stats=copy.deepcopy(bn.state_dict()),
                kind=type(bn).__name__)


def _segmentor(task):
    from pfst_tpu_torch.models import build_segmentor
    model = build_segmentor(copy.deepcopy(task['model']))
    model.load_state_dict(task['weights'])
    return model.eval()


def task_multi_gpu_test(task, rank, world, groups):
    from pfst_tpu_torch.apis import multi_gpu_test
    model = _segmentor(task)
    loader = ToyLoader(ToyDataset(**task['dataset']))
    return {pre_eval: multi_gpu_test(model, loader, pre_eval=pre_eval,
                                     progress=False)
            for pre_eval in (True, False)}


def task_slide(task, rank, world, groups):
    from pfst_tpu_torch.parallel import sharded_slide_inference
    return sharded_slide_inference(_segmentor(task), task['scene'],
                                   task['crop'], task['stride'])


def task_loop(task, rank, world, groups):
    """``train_segmentor`` on this rank under the default group: its
    history and the final student."""
    from pfst_tpu_torch.apis import train_segmentor
    from pfst_tpu_torch.utils import Config
    history = []
    state = train_segmentor(Config.fromfile(task['config']),
                            work_dir=task['work_dir'],
                            max_iters_override=task['iters'], device='cpu',
                            seed=0, history=history)
    return dict(history=history,
                student=copy.deepcopy(state.student.state_dict()))


TASKS = {'step': task_step, 'sync_bn': task_sync_bn,
         'multi_gpu_test': task_multi_gpu_test, 'slide': task_slide,
         'loop': task_loop}


def main(argv):
    torch.set_num_threads(1)
    import torch.distributed as dist
    rank, world = int(argv[1]), int(argv[2])
    dist.init_process_group(
        'gloo', init_method=f'file://{argv[3]}', rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=JOIN_SECONDS))
    singles = [dist.new_group([r]) for r in range(world)]
    groups = {'world': dist.group.WORLD, 'single': singles[rank]}
    job = torch.load(argv[4], weights_only=False)
    out = {name: TASKS[task['kind']](task, rank, world, groups)
           for name, task in job.items()}
    torch.save(out, osp.join(argv[5], f'rank{rank}.pt'))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == '__main__':
    main(sys.argv)
