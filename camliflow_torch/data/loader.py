"""Batched data loading on worker threads: the port's copy of
camliflow_tpu/data/loader.py for one process (DDP's per-rank sharding is
not ported; see ROADMAP.md).

Each epoch's order is a shuffle seeded by (seed + epoch), so a resumed run
reads the batches an uninterrupted one reads; `drop_last` drops the
trailing partial batch (a training step wants full batches). Samples are
read by a pool of threads, a batch ahead of the consumer, and stacked by
`datasets.collate`.
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
                 drop_last: bool = True, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
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
        batches = [indices[b * self.batch_size:(b + 1) * self.batch_size]
                   for b in range(len(self))]
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
