"""The ranks of ``tests/test_torch_ddp.py`` and of the sharded modes'
tests (``test_torch_zero_tp.py``, ``test_torch_pp_ep.py``,
``test_torch_spatial.py``): a process group of the port on the CPU,
without JAX.

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


# -- the sharded modes (tests/test_torch_zero_tp.py, test_torch_pp_ep.py,
# test_torch_spatial.py) -------------------------------------------------
def _layout(task):
    from pfst_tpu_torch.parallel import tp, zero
    return tp.get_2d_groups(task['tp']) if task.get('tp', 1) > 1 \
        else zero.get_data_layout()


def _whole_modules(state):
    """The state's segmentors' whole state dicts (collective)."""
    from pfst_tpu_torch.parallel import zero
    sh = state.sharding
    sh.gather_trees()
    try:
        return {name: {k: v.clone() for k, v in
                       sh.whole_state_dict(getattr(state, name)).items()}
                for name in ('student', 'teacher')
                if getattr(state, name, None) is not None}
    finally:
        sh.release_trees()


def _single_steps(task, batch):
    """The port's single-process steps over the global batch."""
    algo, state = train_state(task)
    step = algo.make_train_step(MEAN, STD)
    logs = []
    for seed in task['gen_seeds']:
        state, lv = step(state, batch, torch.Generator().manual_seed(seed))
        logs.append({k: v.item() for k, v in lv.items()})
    return logs, {name: copy.deepcopy(getattr(state, name).state_dict())
                  for name in ('student', 'teacher')
                  if getattr(state, name, None) is not None}


def task_gspmd_step(task, rank, world, groups):
    """ZeRO (``task['zero']`` 1 or 3) and / or tensor parallelism
    (``task['tp']``) steps of this rank's rows of the global batch, with
    the single-process step's generators: each step's log vars, the whole
    modules after, the memory audit, the specs; with ``single`` rank 0's
    single-process steps; with ``resume`` (ZeRO-3) a whole checkpoint
    after the first step, loaded into the single-process port and into a
    fresh sharded state, each stepping on."""
    from pfst_tpu_torch.core.checkpoint import (load_checkpoint,
                                                restore_state,
                                                save_checkpoint)
    from pfst_tpu_torch.parallel import tp, zero
    layout = _layout(task)
    batch = task['batch']
    n = batch['img'].shape[0] // layout.n_data
    rows = slice(layout.data_index * n, (layout.data_index + 1) * n)
    mine = {k: v[rows] for k, v in batch.items()}
    algo, state = train_state(task)
    out = {}
    state = zero.attach(state, layout, task.get('zero', 0))
    if task.get('specs'):
        out['tp_specs'] = tp.tree_specs(state.student)
        out['zero_specs'] = zero.zero_specs(state, layout.n_data,
                                            task.get('zero') or 1)
    step = zero.make_global_step(algo, MEAN, STD, state.sharding)
    logs = []
    for i, seed in enumerate(task['gen_seeds']):
        state, lv = step(state, mine, torch.Generator().manual_seed(seed))
        logs.append({k: v.item() for k, v in lv.items()})
        if i == 0 and task.get('resume'):
            path = save_checkpoint(task['dir'], state.step, state)
    out.update(logs=logs, modules=_whole_modules(state),
               opt_bytes=zero.opt_state_bytes(state.optimizer),
               tree_bytes={name: zero.tree_bytes(getattr(state, name))
                           for name in ('student', 'teacher')
                           if getattr(state, name, None) is not None},
               local={k: v.clone() for k, v in
                      state.student.state_dict().items()},
               tp_keys=sorted(k for k, p in state.student.named_parameters()
                              if getattr(p, 'tp_dim', None) is not None))
    if task.get('resume'):
        ckpt = load_checkpoint(path)
        # a fresh sharded state resumed from the whole checkpoint
        algo2, fresh = train_state(task)
        fresh = zero.attach(restore_state(fresh, ckpt), layout,
                            task['zero'])
        step2 = zero.make_global_step(algo2, MEAN, STD, fresh.sharding)
        fresh, lv = step2(fresh, mine, torch.Generator().manual_seed(
            task['gen_seeds'][1]))
        out['resumed'] = dict(log_vars={k: v.item() for k, v in lv.items()},
                              modules=_whole_modules(fresh))
        if rank == 0:
            # the single-process port reads the same file and steps on
            algo3, single = train_state(task)
            single = restore_state(single, ckpt)
            single, lv = algo3.make_train_step(MEAN, STD)(
                single, batch,
                torch.Generator().manual_seed(task['gen_seeds'][1]))
            out['resumed_single'] = dict(
                log_vars={k: v.item() for k, v in lv.items()},
                student=copy.deepcopy(single.student.state_dict()),
                ckpt_keys=sorted(ckpt['state_dict']),
                opt_state=ckpt['optimizer'])
    if task.get('single') and rank == 0:
        out['single'] = _single_steps(task, batch)
    return out


def task_gspmd_loop(task, rank, world, groups):
    """``train_segmentor`` with ``task['parallel']`` under the default
    group, then, on rank 0, the single-process run of the same config: the
    histories and the students."""
    from pfst_tpu_torch.apis import train_segmentor
    from pfst_tpu_torch.utils import Config

    def run(parallel, work_dir):
        cfg = Config.fromfile(task['config'])
        cfg.merge_from_dict({f'parallel.{k}': v
                             for k, v in parallel.items()})
        history = []
        state = train_segmentor(cfg, work_dir=work_dir,
                                max_iters_override=task['iters'],
                                device='cpu', seed=0, history=history)
        from pfst_tpu_torch.core.checkpoint import load_checkpoint
        ckpt = load_checkpoint(osp.join(work_dir, f'iter_{task["iters"]}'
                                        '.pth'))
        return dict(history=[h for h in history if h['kind'] == 'log'],
                    ckpt=ckpt['state_dict'])

    out = run(task['parallel'], task['work_dir'])
    if rank == 0:
        import torch.distributed as dist
        group = dist.group.WORLD
        # the single-process run outside the group
        from pfst_tpu_torch.parallel import mesh
        real = mesh.default_group, mesh.get_dist_info
        mesh.default_group = lambda: None
        mesh.get_dist_info = lambda: (0, 1)
        import pfst_tpu_torch.apis.train as train_api
        saved = train_api.default_group, train_api.get_dist_info
        train_api.default_group, train_api.get_dist_info = \
            mesh.default_group, mesh.get_dist_info
        import pfst_tpu_torch.core.checkpoint as ckpt_api
        ckpt_saved = ckpt_api.get_dist_info
        ckpt_api.get_dist_info = mesh.get_dist_info
        try:
            out['single'] = run({}, task['work_dir'] + '_single')
        finally:
            mesh.default_group, mesh.get_dist_info = real
            train_api.default_group, train_api.get_dist_info = saved
            ckpt_api.get_dist_info = ckpt_saved
        del group
    return out


def _first(groups, n):
    """The group of the first ``n`` ranks (the world at its size)."""
    return groups['first'].get(n, groups['world'])


def task_gpipe(task, rank, world, groups):
    """``gpipe_apply`` on the first ``task['stages']`` ranks: the output,
    and the gradients of the sum of its squares with respect to the input
    and this stage's parameters."""
    from pfst_tpu_torch.parallel.pp import gpipe_apply, module_block_fn
    group = _first(groups, task['stages'])
    if rank >= task['stages']:
        return None
    if task.get('vit'):
        from pfst_tpu_torch.models.backbones.vit import ViTBlock
        block = ViTBlock(*task['vit'])
        fn = module_block_fn(block)
    else:
        def fn(p, x):
            h = torch.tanh(x @ p['w1'] + p['b1'])
            return x + h @ p['w2']
    stacked = {k: v.clone().requires_grad_() for k, v in
               task['params'].items()}
    x = task['x'].clone().requires_grad_()
    out = gpipe_apply(fn, stacked, x, group, task['m'])
    (out ** 2).sum().backward()
    return dict(out=out.detach(), dx=x.grad,
                grads={k: v.grad[rank] for k, v in stacked.items()})


def task_moe(task, rank, world, groups):
    """``moe_apply`` on the first ``task['experts']`` ranks, each with its
    share of the tokens: the outputs, and the gradients of the sum of their
    squares for the experts' parameters and the gate."""
    from pfst_tpu_torch.parallel.ep import moe_apply
    e = task['experts']
    group = _first(groups, e)
    if rank >= e:
        return None
    stacked = {k: v.clone().requires_grad_() for k, v in
               task['params'].items()}
    gate = task['gate'].clone().requires_grad_()
    x = shard(task['x'], rank, e)

    def expert(p, t):
        return torch.tanh(t @ p['w']) @ p['v']

    out = moe_apply(expert, stacked, x, gate, group, task['cf'])
    (out ** 2).sum().backward()
    return dict(out=out.detach(), grads={k: v.grad[rank] for k, v in
                                         stacked.items()},
                gate_grad=gate.grad)


def task_spatial(task, rank, world, groups):
    """``spatial_inference`` (or, with ``pad``, the edge-padding
    ``make_spatial_inference_fn``) of ``task['scene']`` on the first
    ``task['ranks']`` ranks: the logits on rank 0."""
    from pfst_tpu_torch.parallel.spatial import (make_spatial_inference_fn,
                                                 spatial_inference)
    n = task['ranks']
    group = _first(groups, n)
    if rank >= n:
        return None
    model = _segmentor(task)
    scene = task['scene']
    if task.get('pad'):
        out = make_spatial_inference_fn(model, n, group)(scene)
    else:
        out = spatial_inference(model, scene, group, grid=task.get('grid'),
                                softmax=task.get('softmax', False))
    return out


def task_spatial_test(task, rank, world, groups):
    """``single_gpu_test(spatial=world)`` on the toy dataset, and the test
    CLI's ``--spatial`` on a config and checkpoint, on every rank of the
    default group."""
    from pfst_tpu_torch.apis import single_gpu_test
    model = _segmentor(task)
    loader = ToyLoader(ToyDataset(**task['dataset']))
    out = dict(results=single_gpu_test(model, loader, pre_eval=True,
                                       progress=False, spatial=world))
    if task.get('config'):
        sys.path.insert(0, osp.join(REPO, 'tools'))
        import test_torch
        out['cli'] = test_torch.main([task['config'], task['checkpoint'],
                                      '--eval', 'mIoU', '--device', 'cpu',
                                      '--spatial', str(world)])
    return out


TASKS = {'step': task_step, 'sync_bn': task_sync_bn,
         'multi_gpu_test': task_multi_gpu_test, 'slide': task_slide,
         'loop': task_loop, 'gspmd_step': task_gspmd_step,
         'gspmd_loop': task_gspmd_loop, 'gpipe': task_gpipe,
         'moe': task_moe, 'spatial': task_spatial,
         'spatial_test': task_spatial_test}


def main(argv):
    torch.set_num_threads(1)
    import torch.distributed as dist
    rank, world = int(argv[1]), int(argv[2])
    dist.init_process_group(
        'gloo', init_method=f'file://{argv[3]}', rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=JOIN_SECONDS))
    singles = [dist.new_group([r]) for r in range(world)]
    # the first k ranks, for the building blocks' smaller groups
    firsts = {k: dist.new_group(list(range(k))) for k in range(2, world)}
    groups = {'world': dist.group.WORLD, 'single': singles[rank],
              'first': firsts}
    job = torch.load(argv[4], weights_only=False)
    out = {name: TASKS[task['kind']](task, rank, world, groups)
           for name, task in job.items()}
    torch.save(out, osp.join(argv[5], f'rank{rank}.pt'))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == '__main__':
    main(sys.argv)
