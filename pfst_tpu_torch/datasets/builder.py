"""Dataset/pipeline registries, the dataset builder and the data loader
(port of ``pfst_tpu/datasets/builder.py``; mirrors
``rsiseg/datasets/builder.py``).

``DataLoader`` yields the JAX loader's index stream: one permutation an
epoch from ``np.random.RandomState(seed + epoch)``, rank ``r`` of ``w``
taking indices ``r::w``, ``drop_last``, ``infinite`` and
``set_position``. Samples come from a pool of worker threads (the
default) or, with ``use_processes``, of worker processes started with
``spawn``. Each batch holds the collated arrays as torch tensors (in
pinned host memory with ``pin_memory``, ready for a non-blocking copy to
the card), the metas as lists, and ``indices``, the dataset indices of
its samples.
"""
from __future__ import annotations

import copy
import math
import queue
import threading
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

from ..utils.registry import Registry

DATASETS = Registry('datasets')
PIPELINES = Registry('pipelines')


def build_dataset(cfg, default_args=None):
    """Build a dataset (``datasets/builder.py:47-75``): ``UDADataset`` and
    ``UDADatasetV2`` pair a source and a target dataset, the wrappers
    (``ConcatDataset``, also for a list of configs and for list-valued
    ``img_dir`` / ``split``, ``RepeatDataset``, ``MultiDomainDataset``,
    ``MultiImageMixDataset``) wrap theirs."""
    from .dataset_wrappers import (ConcatDataset, MultiDomainDataset,
                                   MultiImageMixDataset, RepeatDataset)
    from .uda_dataset import UDADataset
    from .uda_dataset_v2 import UDADatasetV2
    if isinstance(cfg, (list, tuple)):
        return ConcatDataset([build_dataset(c, default_args) for c in cfg])
    cfg = copy.deepcopy(dict(cfg))
    dtype = cfg.get('type')
    if dtype in ('UDADataset', 'UDADatasetV2'):
        pair = UDADataset if dtype == 'UDADataset' else UDADatasetV2
        return pair(source=build_dataset(cfg['source'], default_args),
                    target=build_dataset(cfg['target'], default_args),
                    cfg=cfg)
    if dtype == 'MultiDomainDataset':
        return MultiDomainDataset([build_dataset(c, default_args)
                                   for c in cfg['datasets']], cfg)
    if dtype == 'RepeatDataset':
        return RepeatDataset(build_dataset(cfg['dataset'], default_args),
                             cfg['times'])
    if dtype == 'ConcatDataset':
        return ConcatDataset([build_dataset(c, default_args)
                              for c in cfg['datasets']],
                             cfg.get('separate_eval', True))
    if dtype == 'MultiImageMixDataset':
        # the inner dataset first, as rsiseg's builder does
        return MultiImageMixDataset(
            build_dataset(cfg['dataset'], default_args), cfg['pipeline'],
            cfg.get('skip_type_keys'))
    if isinstance(cfg.get('img_dir'), (list, tuple)) or \
            isinstance(cfg.get('split'), (list, tuple)):
        return ConcatDataset(_split_multi_image_dir(cfg, default_args))
    if default_args:
        for k, v in default_args.items():
            cfg.setdefault(k, v)
    return DATASETS.build(cfg)


def _split_multi_image_dir(cfg, default_args):
    """One dataset for each entry of a list-valued ``img_dir`` / ``ann_dir``
    / ``split`` (``datasets/builder.py:78-95``)."""
    img_dirs = cfg['img_dir'] if isinstance(cfg['img_dir'], (list, tuple)) \
        else [cfg['img_dir']]
    ann_dirs = cfg.get('ann_dir')
    ann_dirs = ann_dirs if isinstance(ann_dirs, (list, tuple)) \
        else [ann_dirs] * len(img_dirs)
    splits = cfg.get('split')
    splits = splits if isinstance(splits, (list, tuple)) \
        else [splits] * len(img_dirs)
    datasets = []
    for img_dir, ann_dir, split in zip(img_dirs, ann_dirs, splits):
        c = copy.deepcopy(cfg)
        c['img_dir'], c['ann_dir'], c['split'] = img_dir, ann_dir, split
        datasets.append(build_dataset(c, default_args))
    return datasets


# the dataset of a worker process, set by its initializer
_worker_dataset = None


def _init_worker(dataset, seed, counter):
    global _worker_dataset
    _worker_dataset = dataset
    with counter.get_lock():
        worker_id = counter.value
        counter.value += 1
    np.random.seed((seed + worker_id) % 2**32)


def _worker_getitem(i):
    return _worker_dataset[i]


def collate(samples: List[Dict[str, Any]],
            pin_memory: bool = False) -> Dict[str, Any]:
    """Stack the samples' arrays into torch tensors (in pinned host
    memory with ``pin_memory``); keep everything else as lists."""
    batch: Dict[str, Any] = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray):
            dtype = torch.from_numpy(vals[0].reshape(-1)[:0]).dtype
            out = torch.empty((len(vals), *vals[0].shape), dtype=dtype,
                              pin_memory=pin_memory)
            np.stack(vals, out=out.numpy())
            batch[key] = out
        else:
            batch[key] = vals
    return batch


class DataLoader:
    """Shuffled, sharded, prefetched batch iterator (``builder.py:106``).

    Sharding mirrors ``DistributedSampler``: rank r of world w takes
    indices ``r::w`` of the seeded permutation; epochs reshuffle with
    ``seed + epoch`` (``samplers/distributed_sampler.py:12-69``)."""

    def __init__(self,
                 dataset,
                 samples_per_gpu: int = 2,
                 workers_per_gpu: int = 2,
                 shuffle: bool = True,
                 seed: int = 0,
                 drop_last: Optional[bool] = None,
                 rank: int = 0,
                 world_size: int = 1,
                 infinite: bool = False,
                 use_processes: bool = False,
                 pin_memory: bool = False):
        self.dataset = dataset
        self.batch_size = samples_per_gpu
        self.num_workers = max(1, workers_per_gpu)
        self.shuffle = shuffle
        self.seed = seed
        self.rank = rank
        self.world_size = world_size
        self.infinite = infinite
        self.drop_last = shuffle if drop_last is None else drop_last
        self.use_processes = bool(use_processes)
        self.pin_memory = pin_memory
        self.epoch = 0
        self._pool = None
        self._skip_batches = 0

    def __len__(self):
        return self.batches_per_epoch()

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            idx = np.random.RandomState(self.seed + epoch).permutation(n)
        else:
            idx = np.arange(n)
        return idx[self.rank::self.world_size]

    def batches_per_epoch(self) -> int:
        n = len(self._epoch_indices(0))
        if self.drop_last:
            return n // self.batch_size
        return math.ceil(n / self.batch_size)

    def set_position(self, batch_idx: int) -> None:
        """Make the next batch yielded global batch ``batch_idx``
        (counted from iteration 0): the data position of a resumed run.
        The permutations are functions of ``seed + epoch``, so no sample
        is produced and dropped."""
        if batch_idx < 0:
            raise ValueError(f'negative batch_idx {batch_idx}')
        bpe = max(self.batches_per_epoch(), 1)
        self.epoch = batch_idx // bpe
        self._skip_batches = batch_idx % bpe

    def _get_pool(self):
        """The worker pool, created at first use and kept across epochs:
        threads (the pipelines' numpy and C++ work releases the GIL), or
        ``spawn``-started processes with ``use_processes``, each seeding
        ``np.random`` with ``seed`` plus its worker number."""
        if self._pool is None:
            if self.use_processes:
                import multiprocessing as mp
                from concurrent.futures import ProcessPoolExecutor
                ctx = mp.get_context('spawn')
                self._pool = ProcessPoolExecutor(
                    self.num_workers, mp_context=ctx,
                    initializer=_init_worker,
                    initargs=(self.dataset, self.seed, ctx.Value('i', 0)))
                self._map_fn = _worker_getitem
            else:
                from concurrent.futures import ThreadPoolExecutor
                self._pool = ThreadPoolExecutor(self.num_workers)
                self._map_fn = self.dataset.__getitem__
        return self._pool

    def close(self):
        """Shut the worker pool down."""
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None

    def _iter_epoch(self, epoch: int) -> Iterator[Dict[str, Any]]:
        indices = self._epoch_indices(epoch)
        nb = len(indices) // self.batch_size if self.drop_last else \
            math.ceil(len(indices) / self.batch_size)
        first_batch = self._skip_batches
        self._skip_batches = 0
        q: 'queue.Queue' = queue.Queue(maxsize=max(2, self.num_workers))
        stop = threading.Event()
        pool = self._get_pool()

        def put_or_stop(item) -> bool:
            """A bounded put that gives up once the consumer has left,
            so an abandoned iterator does not keep its producer."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for bi in range(first_batch, nb):
                    if stop.is_set():
                        return
                    sel = indices[bi * self.batch_size:(bi + 1) *
                                  self.batch_size]
                    samples = list(pool.map(self._map_fn,
                                            [int(i) for i in sel]))
                    batch = collate(samples, self.pin_memory)
                    batch['indices'] = torch.from_numpy(sel.copy())
                    if not put_or_stop(('batch', batch)):
                        return
            except BaseException as e:  # re-raised in the consumer
                put_or_stop(('error', e))
                return
            put_or_stop(('done', None))

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                kind, item = q.get()
                if kind == 'error':
                    raise item
                if kind == 'done':
                    break
                yield item
        finally:
            stop.set()

    def __iter__(self):
        if len(self) == 0:
            raise ValueError(
                f'DataLoader yields 0 batches: dataset of '
                f'{len(self.dataset)} split over world_size='
                f'{self.world_size} gives {len(self._epoch_indices(0))} '
                f'samples/rank for batch_size={self.batch_size} '
                f'(drop_last={self.drop_last})')
        if self.infinite:
            epoch = self.epoch
            while True:
                yield from self._iter_epoch(epoch)
                epoch += 1
        else:
            yield from self._iter_epoch(self.epoch)
            self.epoch += 1


def build_dataloader(dataset,
                     samples_per_gpu,
                     workers_per_gpu,
                     num_gpus=1,
                     dist=False,
                     shuffle=True,
                     seed=None,
                     drop_last=False,
                     pin_memory=False,
                     rank=0,
                     world_size=1,
                     infinite=False,
                     use_processes=False,
                     **kwargs):
    """Public builder (signature mirrors ``datasets/builder.py:100``),
    with mmseg's meaning of ``dist`` and ``num_gpus``: with ``dist`` each
    rank of the default process group draws ``samples_per_gpu`` from its
    ``rank::world_size`` shard of the seeded permutation; without it,
    ``num_gpus`` multiplies the batch and the workers of one loader
    (``rank`` and ``world_size`` shard it by hand)."""
    if dist:
        from ..parallel.mesh import get_dist_info
        rank, world_size = get_dist_info()
    else:
        samples_per_gpu *= num_gpus
        workers_per_gpu *= num_gpus
    return DataLoader(
        dataset,
        samples_per_gpu=samples_per_gpu,
        workers_per_gpu=workers_per_gpu,
        shuffle=shuffle,
        seed=seed or 0,
        drop_last=drop_last or shuffle,
        rank=rank,
        world_size=world_size,
        infinite=infinite,
        use_processes=use_processes,
        pin_memory=pin_memory)
