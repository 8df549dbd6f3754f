"""Host data loading: the rank-sharded infinite sampler, the batch loader
and the prefetch of batches onto the card (counterpart of
``fsnet_tpu.data.dataloader``).

* :class:`TrainingSampler`: an infinite stream of dataset indices, a
  ``RandomState(seed)`` permutation per pass, sharded ``indices[rank::world]``.
  Each ``iter()`` starts the stream from its seed again, as the JAX
  sampler's does, so every epoch of the training loop (which takes a new
  iterator per epoch) walks the first epoch's order.
* :class:`Dataloader`: ``iter(loader)`` yields one epoch, ``len(loader)``
  collated, string-keyed batches: the JAX loader's stream, which runs on
  forever, cut where its training loop stops taking from it. Ending there
  leaves no batch in flight at the epoch's end, so the workers do no work
  that is thrown away and are idle when they are stopped. With
  ``num_workers=0`` the batches are numpy arrays made in-line (the JAX
  loader's batches, bit for bit). With workers they are tensors made by
  ``torch.utils.data.DataLoader`` worker processes (started with ``spawn``,
  kept across iterators, closed by :meth:`Dataloader.close`), in the
  sampler's order, pinned where ``pin_memory`` is set. Each worker reseeds
  every numpy generator of its copy of the dataset (:func:`reseed_numpy`)
  from the worker seed PyTorch gives it, so no two workers draw the same
  augmentation stream (each starts from a copy of the parent's
  generators).
* :func:`device_prefetch`: keeps ``size`` batches ahead on the device,
  copied from pinned host memory on a side stream; the consuming stream
  waits for an event recorded after that batch's copies before the batch is
  handed out, and each tensor is recorded on the consuming stream
  (``record_stream``), so a step never reads a half-copied batch and the
  batch's memory is not reused while the step may still read it.
"""
from __future__ import annotations

import collections
import functools
import itertools
from typing import Any, Callable, Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from ..utils.builder import build
from ..utils.device import DeviceLike, resolve_device
from ..utils.keys import encode_batch
from .datasets.dataset_utils import collate_fn


class TrainingSampler:
    """Infinite stream of dataset indices, sharded ``indices[rank::world]``,
    shuffled per pass by a ``RandomState(seed)``."""

    def __init__(self, size: int, shuffle: bool = True,
                 seed: Optional[int] = None, rank: int = 0,
                 world_size: int = 1):
        self._size = size
        self._shuffle = shuffle
        self._seed = int(seed) if seed is not None else 2 ** 31
        self._rank = rank
        self._world_size = world_size

    def __iter__(self) -> Iterator[int]:
        yield from itertools.islice(self._infinite_indices(), self._rank,
                                    None, self._world_size)

    def _infinite_indices(self) -> Iterator[int]:
        rng = np.random.RandomState(self._seed)
        while True:
            if self._shuffle:
                yield from rng.permutation(self._size).tolist()
            else:
                yield from range(self._size)


class InferenceSampler:
    """One sequential pass."""

    def __init__(self, size: int):
        self._size = size

    def __iter__(self):
        return iter(range(self._size))

    def __len__(self):
        return self._size


def reseed_numpy(obj: Any, seed: int) -> int:
    """Replaces every ``np.random.Generator`` and ``np.random.RandomState``
    reachable from ``obj`` (attributes, lists, tuples and dict values) by a
    new one of the same kind, the k-th found seeded from
    ``SeedSequence([seed, k])``. Returns how many it replaced."""
    found = [0]
    seen = set()

    def fresh(kind):
        child = np.random.SeedSequence([seed, found[0]])
        found[0] += 1
        if kind is np.random.Generator:
            return np.random.default_rng(child)
        return np.random.RandomState(child.generate_state(1)[0])

    def walk(node):
        if id(node) in seen:
            return node
        seen.add(id(node))
        if isinstance(node, (np.random.Generator, np.random.RandomState)):
            return fresh(type(node))
        if isinstance(node, list):
            node[:] = [walk(v) for v in node]
        elif isinstance(node, dict):
            for k in list(node):
                node[k] = walk(node[k])
        elif isinstance(node, tuple):
            for v in node:
                walk(v)
        elif hasattr(node, "__dict__") and not isinstance(node, type):
            for k, v in list(vars(node).items()):
                setattr(node, k, walk(v))
        return node

    walk(obj)
    return found[0]


def _seed_worker(worker_id: int) -> None:
    info = torch.utils.data.get_worker_info()
    reseed_numpy(info.dataset, info.seed)
    np.random.seed(info.seed % 2 ** 32)


def _collate_tensors(samples, collate: Callable) -> Dict[str, Any]:
    """A worker's batch: encoded keys, arrays as tensors (shared with the
    main process rather than pickled)."""
    batch = encode_batch(collate(samples))
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            if isinstance(v, np.ndarray) else v for k, v in batch.items()}


class _IndexBatches:
    """The loader's index batches as an iterable for PyTorch's loader."""

    def __init__(self, loader: "Dataloader"):
        self.loader = loader

    def __iter__(self):
        return self.loader._epoch()


# batches in flight per loader worker
_PREFETCH = 2


class Dataloader:
    """Map-style batch loader; ``iter(loader)`` yields string-keyed batches
    (see the module docstring)."""

    def __init__(self, dataset, batch_size: int, sampler,
                 collate: Callable = collate_fn, num_workers: int = 4,
                 drop_last: bool = True, pin_memory: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler
        self.collate = collate
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.pin_memory = pin_memory
        self._workers = None

    def __len__(self):
        n = len(self.dataset)
        return (n // self.batch_size if self.drop_last
                else -(-n // self.batch_size))

    def _index_batches(self) -> Iterator[Sequence[int]]:
        it = iter(self.sampler)
        while True:
            idxs = list(itertools.islice(it, self.batch_size))
            if not idxs:
                return
            if len(idxs) < self.batch_size and self.drop_last:
                return
            yield idxs

    def _epoch(self) -> Iterator[Sequence[int]]:
        return itertools.islice(self._index_batches(), len(self))

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        if self.num_workers == 0:
            for idxs in self._epoch():
                yield encode_batch(self.collate([self.dataset[i]
                                                 for i in idxs]))
            return
        if self._workers is None:
            self._workers = torch.utils.data.DataLoader(
                self.dataset, batch_sampler=_IndexBatches(self),
                collate_fn=functools.partial(_collate_tensors,
                                             collate=self.collate),
                num_workers=self.num_workers, prefetch_factor=_PREFETCH,
                persistent_workers=True, pin_memory=self.pin_memory,
                worker_init_fn=_seed_worker,
                multiprocessing_context="spawn")
        yield from self._workers

    def close(self) -> None:
        """Stops the worker processes, if any were started."""
        workers, self._workers = self._workers, None
        it = getattr(workers, "_iterator", None)
        if it is not None:
            it._shutdown_workers()


def build_dataloader(dataset, num_workers: int = 4, batch_size: int = 8,
                     collate_fn: Callable = collate_fn, local_rank: int = -1,
                     world_size: int = 1, sampler_cfg: Optional[Dict] = None,
                     pin_memory: bool = False, **kwargs) -> Dataloader:
    """Config-facing factory: a :class:`TrainingSampler` (or
    ``sampler_cfg``'s) over ``dataset``, dropping the last partial batch."""
    sampler_cfg = dict(
        sampler_cfg or dict(name="fsnet_tpu_torch.data.dataloader."
                                 "TrainingSampler", shuffle=True))
    sampler = build(size=len(dataset), rank=max(local_rank, 0),
                    world_size=max(world_size, 1), **sampler_cfg)
    return Dataloader(dataset, batch_size=batch_size, sampler=sampler,
                      collate=collate_fn, num_workers=num_workers,
                      drop_last=True, pin_memory=pin_memory)


def _as_tensor(v):
    if isinstance(v, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(v))
    return v


def device_prefetch(iterator: Iterator, device: DeviceLike = "cuda",
                    size: int = 2) -> Iterator[Dict[str, Any]]:
    """Wrap a host batch iterator so that ``size`` batches are already on
    ``device`` (a CUDA device unless the caller asks for the CPU) when one
    is handed out; see the module docstring. On the CPU the batches' arrays
    become tensors and nothing runs ahead."""
    dev = resolve_device(device)
    it = iter(iterator)
    if dev.type != "cuda":
        for batch in it:
            yield {k: _as_tensor(v) for k, v in batch.items()}
        return

    stream = torch.cuda.Stream(dev)

    def put(batch):
        out = {}
        with torch.cuda.stream(stream):
            for k, v in batch.items():
                v = _as_tensor(v)
                if isinstance(v, torch.Tensor):
                    if not v.is_pinned():
                        v = v.pin_memory()
                    v = v.to(dev, non_blocking=True)
                out[k] = v
            copied = torch.cuda.Event()
            copied.record(stream)
        return out, copied

    buf = collections.deque(put(b) for b in itertools.islice(it, size))
    while buf:
        batch, copied = buf.popleft()
        nxt = next(it, None)
        if nxt is not None:
            buf.append(put(nxt))
        consumer = torch.cuda.current_stream(dev)
        consumer.wait_event(copied)
        for v in batch.values():
            if isinstance(v, torch.Tensor):
                v.record_stream(consumer)
        yield batch
