"""Host-side batch loader: deterministic sharded order + thread prefetch.

Replaces the reference's torch DataLoader + DistributedSampler stack
(run_generation.py:366-377): per-host shard selection plays the role of
DistributedSampler (drop_last=True semantics), a worker thread pool plays
num_workers, and a bounded queue plays prefetch_factor. Batches are stacked
numpy dicts with fixed shapes, ready for jnp.device_put / pjit sharding.

Copy of mmgl_tpu/data/loader.py for the PyTorch port, with its imports
rewritten to the port: the JAX package's data layer reaches flax through
models/graph.py, and the port imports no JAX. The code is otherwise
unchanged, so the two produce identical batches.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterator, List

import numpy as np


class PrefetchLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0, shard_id: int = 0, num_shards: int = 1,
                 drop_last: bool = True, prefetch: int = 10,
                 num_workers: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.drop_last = drop_last
        # prefetch <= 0 would make the worker bound permanently true
        # (next_fetch - next_emit >= 0) and deadlock the consumer
        self.prefetch = max(1, prefetch)
        self.num_workers = max(1, num_workers)
        self.epoch = 0
        self.pass_idx = 0

    def set_epoch(self, epoch: int, pass_idx: int = 0):
        """Reshuffle per epoch (DistributedSampler.set_epoch parity).

        pass_idx distinguishes repeated passes over the data inside one
        epoch (steps_per_epoch > one pass): the shuffle is a deterministic
        function of (seed, epoch, pass_idx), identical on every process, so
        shard disjointness survives mid-epoch reshuffles.
        """
        self.epoch = epoch
        self.pass_idx = pass_idx

    def _order(self) -> np.ndarray:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(
                (self.seed + self.epoch * 1_000_003 + self.pass_idx)
                % (2**32))
            rng.shuffle(idx)
        # equalize shard lengths BEFORE striding (DistributedSampler
        # truncates to floor(n/S)*S): otherwise shard 0 can get one extra
        # sample and, after per-shard drop_last, a different batch count —
        # which deadlocks the per-batch gather_tokens collective in
        # multi-host eval and desyncs the StopIteration-triggered reshuffle
        usable_n = (n // self.num_shards) * self.num_shards
        idx = idx[:usable_n]
        idx = idx[self.shard_id::self.num_shards]
        if self.drop_last:
            usable = (len(idx) // self.batch_size) * self.batch_size
            idx = idx[:usable]
        return idx

    def __len__(self) -> int:
        return len(self._order()) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = self._order()
        batches = [order[i : i + self.batch_size]
                   for i in range(0, len(order), self.batch_size)]
        if not batches:
            return
        stop = threading.Event()
        lock = threading.Lock()
        cursor = {"next_fetch": 0, "next_emit": 0}
        done: Dict[int, Dict[str, np.ndarray]] = {}
        cond = threading.Condition(lock)

        def worker():
            while not stop.is_set():
                with cond:
                    # honor the prefetch bound: without it, workers race
                    # through the whole pass and park every batch in `done`
                    # (unbounded host memory — at the raw-image shapes a
                    # 27-batch pass is ~780 MB). Up to num_workers batches
                    # are additionally in flight past the bound.
                    while (not stop.is_set()
                           and cursor["next_fetch"] - cursor["next_emit"]
                           >= self.prefetch):
                        cond.wait(timeout=0.1)
                    if stop.is_set():
                        return
                    i = cursor["next_fetch"]
                    if i >= len(batches):
                        return
                    cursor["next_fetch"] += 1
                batch = _stack([self.dataset[int(j)] for j in batches[i]])
                with cond:
                    done[i] = batch
                    cond.notify_all()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            for i in range(len(batches)):
                with cond:
                    while i not in done:
                        cond.wait(timeout=0.1)
                        if stop.is_set():
                            return
                    batch = done.pop(i)
                    cursor["next_emit"] = i + 1
                    cond.notify_all()
                yield batch
        finally:
            stop.set()
            with cond:
                cond.notify_all()


def _stack(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    keys = samples[0].keys()
    return {k: np.stack([s[k] for s in samples]) for k in keys}
