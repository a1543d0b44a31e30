"""Batch loader, the counterpart of ``si_mamba_tpu/data/loader.py`` (the
reference's DataLoader): numpy batching, shuffling,
process shards and threaded prefetch, with batches byte-equal to the JAX
package's.

Several processes: each loads its 1/process_count shard of the sample index
space (``process_index``/``process_count``), as DistributedSampler does; the
shuffle is seeded with the epoch (its ``set_epoch``).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np


class Loader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0,
                 process_index: int = 0, process_count: int = 1,
                 prefetch: int = 2, num_workers: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        self.prefetch = prefetch
        # batch-assembly threads (DataLoader's num_workers). Threads, not
        # processes: __getitem__ is file IO and numpy, which release the GIL,
        # and no process is forked from one that holds CUDA state. Batches are
        # assigned round-robin and yielded strictly in order, so the stream is
        # that of num_workers=1 for a dataset whose samples draw no random
        # numbers. __getitem__ must be thread-safe.
        self.num_workers = max(1, int(num_workers))

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            idx = np.random.default_rng(self.seed + epoch).permutation(n)
        if self.process_count > 1:
            # pad to even shards (DistributedSampler semantics: wrap around)
            per = -(-n // self.process_count)
            idx = np.concatenate([idx, idx[: per * self.process_count - n]])
            idx = idx[self.process_index::self.process_count]
        return idx

    def __len__(self):
        n = len(self._epoch_indices(0))
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def epoch(self, epoch: int = 0) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """Yields (points (B, N, 3) f32, labels (B,) i32) with prefetching."""
        idx = self._epoch_indices(epoch)
        nb = len(idx) // self.batch_size if self.drop_last else -(-len(idx) // self.batch_size)

        def make(bi):
            sel = idx[bi * self.batch_size : (bi + 1) * self.batch_size]
            pts, labels = zip(*(self.dataset[int(i)] for i in sel))
            return (np.stack(pts).astype(np.float32),
                    np.asarray(labels, np.int32))

        if self.prefetch <= 0:
            for bi in range(nb):
                yield make(bi)
            return

        W = min(self.num_workers, max(nb, 1))
        # ``prefetch`` is a SHARED budget (total buffered batches stays
        # ~prefetch + W regardless of W, not W*prefetch)
        per_q = max(1, -(-self.prefetch // W))
        qs = [queue.Queue(maxsize=per_q) for _ in range(W)]
        stop = threading.Event()

        def worker(w):
            try:
                for bi in range(w, nb, W):
                    item = make(bi)
                    # bounded put that a closed/abandoned generator can
                    # release — otherwise W threads (and their buffered
                    # batches) stay pinned per abandoned epoch
                    while not stop.is_set():
                        try:
                            qs[w].put(item, timeout=0.2)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except BaseException as e:  # propagate loader errors to the consumer
                while not stop.is_set():
                    try:
                        qs[w].put(e, timeout=0.2)
                        break
                    except queue.Full:
                        continue

        for w in range(W):
            threading.Thread(target=worker, args=(w,), daemon=True).start()
        try:
            # strict-order consumption: batch bi always comes from worker bi % W
            for bi in range(nb):
                item = qs[bi % W].get()
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()

    def __iter__(self):
        return self.epoch(0)
