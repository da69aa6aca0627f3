"""Data parallelism over a process group (port of
``pfst_tpu/parallel/mesh.py``).

The JAX file shards the batch over a 1-D ``data`` mesh inside one
program and ``pmean``s the gradients, the log vars and the new BN running
statistics. Here each GPU is a process of a ``torch.distributed`` group
(``init_distributed``: torchrun's or Slurm's environment), each rank
loads its own shard of the data, and the train step calls explicit
collectives where the JAX step has its ``pmean``:

* ``broadcast_state``: rank 0's modules once at the start (the JAX state
  is replicated by construction);
* ``average_gradients``: after the whole backward, a flat ``all_reduce``
  a bucket of gradients, divided by the world size;
* ``average_log_vars``: the mean of the log vars;
* ``average_buffers``: after the optimizer step, the mean of every
  floating-point buffer (the BN running statistics and EMANet's bases,
  the JAX ``batch_stats``).

Each replica normalizes by its own shard's BN statistics (plain ``BN``)
unless the layer is ``SyncBN`` (``sync_bn.py``). A step given no group
calls none of these, and at a world size of 1 each is exact (a sum of
one tensor, a division by 1), so one rank steps bitwise as one process.
Only ``all_reduce`` and ``broadcast`` are used on tensors: gloo has no
other collective for CUDA tensors, and two gloo ranks can share one GPU.
"""
from __future__ import annotations

import datetime
import os
import subprocess
from typing import Dict, Iterable, List, Optional, Tuple

import torch
import torch.distributed as dist

from .global_batch import is_global_batch

# DistributedDataParallel's default bucket size
BUCKET_BYTES = 25 * 2**20
# a join or a collective that waits longer than this raises
TIMEOUT = datetime.timedelta(minutes=30)
# the master's port under Slurm when MASTER_PORT is not set (mmcv's)
SLURM_PORT = 29500


def get_dist_info() -> Tuple[int, int]:
    """(rank, world size) in the default group, or (0, 1) without an
    initialized group."""
    if not (dist.is_available() and dist.is_initialized()):
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def default_group():
    """The default group when one is initialized, else None (one
    process: the steps call no collective)."""
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


def resolve_backend(backend: Optional[str], device_type: str) -> str:
    """The collective backend of a config's ``dist_params.backend``: the
    JAX configs' ``'xla'`` (or None) means NCCL on the card and gloo on
    the CPU; an explicit backend is kept, and NCCL without the card
    raises."""
    if backend in (None, 'xla'):
        return 'nccl' if device_type == 'cuda' else 'gloo'
    if backend == 'nccl' and device_type != 'cuda':
        raise ValueError('the nccl backend needs the card; use gloo on '
                         'the CPU')
    return backend


def rank_device(local_rank: int, device_type: str = 'cuda') -> torch.device:
    """The device of the rank with ``local_rank`` on its host:
    ``cuda:{local_rank % device_count}``, so that ranks beyond the host's
    GPUs share them (two gloo ranks on one card), or the CPU."""
    if device_type != 'cuda':
        return torch.device(device_type)
    if not torch.cuda.is_available():
        raise RuntimeError('a launcher on the card was asked for and no '
                           'CUDA device is available; pass --device cpu '
                           'to run the ranks on the CPU')
    return torch.device('cuda', local_rank % torch.cuda.device_count())


def _slurm_env() -> Dict[str, str]:
    """torchrun's variables from Slurm's (mmcv's ``_init_dist_slurm``):
    the first host of the job's node list is the master."""
    env = dict(RANK=os.environ['SLURM_PROCID'],
               WORLD_SIZE=os.environ['SLURM_NTASKS'],
               LOCAL_RANK=os.environ['SLURM_LOCALID'])
    if 'MASTER_ADDR' not in os.environ:
        nodes = os.environ['SLURM_NODELIST']
        env['MASTER_ADDR'] = subprocess.check_output(
            ['scontrol', 'show', 'hostnames', nodes], text=True).split()[0]
    if 'MASTER_PORT' not in os.environ:
        env['MASTER_PORT'] = str(SLURM_PORT)
    return env


def init_distributed(launcher: str, backend: Optional[str] = None,
                     device: str = 'cuda') -> torch.device:
    """Join the process group of ``launcher`` and return this rank's
    device (the counterpart of the JAX file's ``init_distributed`` and of
    mmcv's ``init_dist``).

    * ``'none'``: no group; the device is ``device``;
    * ``'pytorch'``: torchrun's ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
      ``MASTER_ADDR`` and ``MASTER_PORT``;
    * ``'slurm'``: ``SLURM_PROCID``, ``SLURM_NTASKS``, ``SLURM_LOCALID``,
      the master from ``SLURM_NODELIST`` unless ``MASTER_ADDR`` is set,
      ``MASTER_PORT`` or 29500.

    ``backend`` is ``resolve_backend``'s. The rank's device is
    ``rank_device``'s, made current on the card. A group that cannot form
    raises: nothing falls back to one process."""
    device_type = torch.device(device).type
    if launcher == 'none':
        return rank_device(0, device_type) if device_type == 'cuda' \
            else torch.device(device)
    if launcher == 'slurm':
        os.environ.update(_slurm_env())
    elif launcher != 'pytorch':
        raise ValueError(f'unknown launcher {launcher!r}')
    missing = [k for k in ('RANK', 'WORLD_SIZE', 'MASTER_ADDR',
                           'MASTER_PORT') if k not in os.environ]
    if missing:
        raise RuntimeError(f'launcher {launcher!r}: {missing} not set '
                           f'(run under torchrun or srun)')
    rank = int(os.environ['RANK'])
    world = int(os.environ['WORLD_SIZE'])
    local = int(os.environ.get('LOCAL_RANK', rank))
    dev = rank_device(local, device_type)
    if dev.type == 'cuda':
        torch.cuda.set_device(dev)
    dist.init_process_group(resolve_backend(backend, dev.type),
                            init_method='env://', rank=rank,
                            world_size=world, timeout=TIMEOUT)
    return dev


def _buckets(tensors: List[torch.Tensor]) -> Iterable[List[torch.Tensor]]:
    """``tensors`` in runs of one device and dtype, each at most
    BUCKET_BYTES (or one tensor), in their order."""
    bucket, key, size = [], None, 0
    for t in tensors:
        k = (t.device, t.dtype)
        nbytes = t.numel() * t.element_size()
        if bucket and (k != key or size + nbytes > BUCKET_BYTES):
            yield bucket
            bucket, size = [], 0
        bucket.append(t)
        key = k
        size += nbytes
    if bucket:
        yield bucket


def _flat_collective(tensors: List[torch.Tensor], op) -> None:
    """``op(flat)`` on each bucket of ``tensors`` flattened into one
    buffer, the result copied back in place."""
    for bucket in _buckets(tensors):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        op(flat)
        offset = 0
        for t in bucket:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n


def _mean_in_place(tensors: List[torch.Tensor], group) -> None:
    world = dist.get_world_size(group)

    def mean(flat):
        dist.all_reduce(flat, group=group)
        flat.div_(world)

    _flat_collective(tensors, mean)


@torch.no_grad()
def average_gradients(params: Iterable[torch.nn.Parameter], group) -> None:
    """The mean over ``group`` of the gradients of ``params`` (an
    optimizer's), in place; a parameter without one takes a zero
    gradient first, as the optimizer's step would give it."""
    if group is None:
        return
    if is_global_batch(group):
        group.average_gradients(params)
        return
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    _mean_in_place([p.grad for p in params], group)


@torch.no_grad()
def average_log_vars(log_vars: Dict[str, torch.Tensor],
                     group) -> Dict[str, torch.Tensor]:
    """The mean over ``group`` of each 0-dim log var, with one
    ``all_reduce`` (the JAX ``pmean(log_vars)``)."""
    if group is None or not log_vars or is_global_batch(group):
        return log_vars
    names = list(log_vars)
    flat = torch.stack([log_vars[k].detach().float() for k in names])
    dist.all_reduce(flat, group=group)
    flat.div_(dist.get_world_size(group))
    return {k: flat[i].to(log_vars[k].dtype) for i, k in enumerate(names)}


@torch.no_grad()
def average_buffers(module: torch.nn.Module, group) -> None:
    """The mean over ``group`` of ``module``'s floating-point buffers
    (the new running statistics each replica's forward passes left). A
    GSPMD step's statistics are the global batch's on every rank."""
    if group is None or is_global_batch(group):
        return
    _mean_in_place([b for b in module.buffers() if b.is_floating_point()],
                   group)


def gradient_norm(params: Iterable[torch.nn.Parameter],
                  group) -> torch.Tensor:
    """The L2 norm of ``params``' gradients: this replica's under data
    parallelism, the whole batch's gradient (after ``average_gradients``)
    in a GSPMD step."""
    params = [p for p in params if p.grad is not None or
              getattr(p, 'zero_shard', None) is not None]
    if is_global_batch(group):
        return group.grad_norm(params)
    return torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm([p.grad for p in params])))


def state_modules(state) -> List[torch.nn.Module]:
    """The modules a train state holds: student, teacher, the frozen
    reference, the discriminator (those that are set)."""
    return [m for m in (getattr(state, k, None) for k in
                        ('student', 'teacher', 'imnet', 'discriminator'))
            if isinstance(m, torch.nn.Module)]


@torch.no_grad()
def broadcast_state(state, group) -> None:
    """Every parameter and buffer of the state's modules from the
    group's first rank to the others, and a check that every rank is at
    the same step. The optimizer's moments are not sent: at the start
    they are empty, and a resumed run loads them from the same
    checkpoint on every rank."""
    if group is None:
        return
    src = dist.get_global_rank(group, 0)
    tensors = [t for m in state_modules(state)
               for t in list(m.parameters()) + list(m.buffers())]
    _flat_collective(tensors, lambda flat: dist.broadcast(
        flat, src=src, group=group))
    step = torch.tensor([float(state.step)], device=tensors[0].device)
    dist.all_reduce(step, group=group)
    world = dist.get_world_size(group)
    if step.item() != world * state.step:
        raise RuntimeError(f'ranks resumed at different steps (sum '
                           f'{step.item()}, this rank {state.step})')


def replicas_agree(flag: bool, group) -> bool:
    """True on every rank when ``flag`` is True on any (the JAX loop's
    vote by allgather, ``train.py:755-770``)."""
    if group is None:
        return flag
    dev = torch.device('cuda', torch.cuda.current_device()) \
        if dist.get_backend(group) == 'nccl' else torch.device('cpu')
    t = torch.tensor([1.0 if flag else 0.0], device=dev)
    dist.all_reduce(t, group=group)
    return bool(t.item() > 0)


def make_sharded_train_step(algo, mean, std, group,
                            collect_vis: bool = False):
    """The data-parallel train step (``mesh.py:80-106``): ``algo``'s step
    with ``group``, ``(state, batch, generator) -> (state, log_vars)``,
    where ``batch`` is this rank's shard and ``generator`` this rank's
    (``apis.train.step_generator(seed, it, rank)``, the JAX
    ``fold_in(rng, axis_index)``). The state must start equal on every
    rank (``broadcast_state``); the step keeps it so."""
    if group is None:
        raise ValueError('make_sharded_train_step needs a process group')
    return algo.make_train_step(mean, std, collect_vis=collect_vis,
                                group=group)
