"""Batched data loading on worker threads: the port's copy of
camliflow_tpu/data/loader.py.

Each epoch's order is a shuffle seeded by (seed + epoch), so a resumed run
reads the batches an uninterrupted one reads; `drop_last` drops the
trailing partial batch (a training step wants full batches). Samples are
read by a pool of threads, a batch ahead of the consumer, and stacked by
`datasets.collate`.

With N ranks (`shard_index` of `num_shards`, `parallel/dist.py`),
`batch_size` is the global batch, which N must divide: every rank walks the
same order of global batches and takes its contiguous slice of each, B/N
samples, so the ranks together read each global batch once. A remainder
batch (`drop_last=False`, evaluation) can leave the later ranks a short or
empty slice; an empty one is skipped. Training drops the remainder, so
every rank takes the same number of steps.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .datasets import collate


class DataLoader:
    """Iterate a dataset (`__len__`, `__getitem__` returning dicts of numpy
    arrays) in batches; `num_workers` threads read ahead (0: read in the
    calling thread)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False, num_workers: int = 4,
                 drop_last: bool = True, seed: int = 0, shard_index: int = 0,
                 num_shards: int = 1):
        if batch_size % num_shards:
            raise ValueError(f"the global batch of {batch_size} does not split over "
                             f"{num_shards} ranks")
        self.dataset = dataset
        self.batch_size = batch_size
        self.local_batch = batch_size // num_shards
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Reseed the shuffle (and the dataset's own draws, where it has
        them) for `epoch`."""
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self):
        """The number of global batches (a rank whose last slice is empty
        reads one fewer)."""
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def _epoch_indices(self) -> np.ndarray:
        indices = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(indices)
        return indices

    def __iter__(self):
        indices = self._epoch_indices()
        start = self.shard_index * self.local_batch
        batches = [indices[b * self.batch_size:(b + 1) * self.batch_size]
                   [start:start + self.local_batch] for b in range(len(self))]
        batches = [batch for batch in batches if len(batch)]
        if self.num_workers <= 0:
            for batch in batches:
                yield collate([self.dataset[int(i)] for i in batch])
            return

        out_queue: queue.Queue = queue.Queue(maxsize=max(2, self.num_workers))
        stop = threading.Event()

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for batch in batches:
                        if stop.is_set():
                            return
                        out_queue.put(collate(list(pool.map(self.dataset.__getitem__,
                                                            map(int, batch)))))
                out_queue.put(None)
            except BaseException as exc:  # handed to the consumer, which raises it
                out_queue.put(exc)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out_queue.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            while thread.is_alive():  # let a producer blocked on a full queue finish
                try:
                    out_queue.get_nowait()
                except queue.Empty:
                    thread.join(timeout=0.05)
