"""Batches from a map-style dataset, and their upload to the card (the
port's copy of ``vimoclip_tpu/data/pipeline.py``).

``BatchLoader`` shuffles per epoch with ``np.random.default_rng((seed,
epoch))``, so the same seed and epoch give the same batches in both
packages, and a resumed run skips the batches it already trained on
(``set_epoch(epoch, start_batch=)``) without loading them. Items load on a
thread pool one batch ahead (h5py releases the GIL while it reads).
``prefetch_to_device`` keeps two batches in flight to the card through
pinned memory and ``non_blocking`` copies.

Spans (``utils/profiling.py::annotate``): ``vimo.data.load_wait`` while a
batch's items are awaited, ``vimo.data.collate`` around ``collate`` and
``vimo.data.upload`` around each batch's upload in ``prefetch_to_device``.
"""

from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from vimoclip_tpu_torch.ops.batching import upload
from vimoclip_tpu_torch.utils.profiling import annotate


class BatchLoader:
    """Deterministic, epoch-seeded batch iterator: ``shuffle`` per epoch,
    ``drop_last``, a custom ``collate``."""

    def __init__(self, dataset, batch_size: int, collate: Callable[[list], dict],
                 shuffle: bool = False, drop_last: bool = False, seed: int = 0,
                 num_workers: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate = collate
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_workers = num_workers
        self._epoch = 0
        self._start_batch = 0

    def set_epoch(self, epoch: int, start_batch: int = 0) -> None:
        """Position the loader; ``start_batch`` skips that many batches of
        this epoch's order without loading them (mid-epoch resume)."""
        self._epoch = epoch
        self._start_batch = start_batch

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _order(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng((self.seed, self._epoch)).shuffle(idx)
        return idx

    def __iter__(self) -> Iterator[dict]:
        order = self._order()
        end = (len(order) // self.batch_size * self.batch_size if self.drop_last
               else len(order))
        batches = [order[i:i + self.batch_size].tolist()
                   for i in range(0, end, self.batch_size)][self._start_batch:]
        if self.num_workers <= 1:
            for b in batches:
                with annotate("vimo.data.load_wait"):
                    items = [self.dataset[i] for i in b]
                yield self._collate(items)
            return
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending = collections.deque(
                pool.map(self.dataset.__getitem__, b) for b in batches[:2])
            for k in range(len(batches)):
                with annotate("vimo.data.load_wait"):
                    items = list(pending.popleft())
                if k + 2 < len(batches):
                    pending.append(pool.map(self.dataset.__getitem__, batches[k + 2]))
                yield self._collate(items)

    def _collate(self, items: list) -> dict:
        with annotate("vimo.data.collate"):
            return self.collate(items)


def to_device(batch: dict, device: torch.device) -> dict:
    """numpy leaves -> tensors on ``device`` (``ops/batching.py::upload``:
    pinned, ``non_blocking`` for a card); other values (video ids, tensors)
    pass through."""
    return {key: upload(value, device) if isinstance(value, np.ndarray) else value
            for key, value in batch.items()}


def prefetch_to_device(iterator: Iterable[dict], device: torch.device | str,
                       size: int = 2) -> Iterator[dict]:
    """Upload batches ``size`` steps ahead of their use."""
    device = torch.device(device)

    def put(batch: dict) -> None:
        with annotate("vimo.data.upload"):
            queue.append(to_device(batch, device))

    queue: collections.deque = collections.deque()
    it = iter(iterator)
    for batch in it:
        put(batch)
        if len(queue) >= size:
            break
    while queue:
        out = queue.popleft()
        nxt = next(it, None)
        if nxt is not None:
            put(nxt)
        yield out
