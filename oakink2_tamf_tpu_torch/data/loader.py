"""Host dataloader: sharded shuffled epochs + threaded prefetch (port of
oakink2_tamf_tpu/data/loader.py).

Replaces the reference's torch DataLoader + DistributedSampler stack
(launch/train.py:394-432): index sharding by striding, per-epoch reshuffle
with a deterministic seed (DistributedSampler.set_epoch parity: the same
numpy permutation as the JAX package), drop_last, and a background thread
that overlaps collate with device work. One shard unless told otherwise
(the port trains on one device for now).
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator, Optional

import numpy as np


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        collate_fn: Callable,
        *,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 0,
        num_shards: Optional[int] = None,
        shard_index: Optional[int] = None,
        prefetch: int = 2,
        num_workers: int = 2,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_shards = num_shards if num_shards is not None else 1
        self.shard_index = shard_index if shard_index is not None else 0
        self.prefetch = prefetch
        self.num_workers = max(1, num_workers)
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        # propagate to epoch-aware datasets (e.g. GaussianPerturbSampleAdaptor)
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def _epoch_indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            idx = rng.permutation(n)
        else:
            idx = np.arange(n)
        # shard by striding (DistributedSampler semantics incl. wrap-padding;
        # np.resize tiles the permutation, so every shard has the same length
        # even when num_shards > 2n)
        if self.num_shards > 1:
            per = int(np.ceil(n / self.num_shards))
            idx = np.resize(idx, per * self.num_shards)
            idx = idx[self.shard_index :: self.num_shards]
        return idx

    def __len__(self) -> int:
        n = len(self._epoch_indices())
        return n // self.batch_size if self.drop_last else int(np.ceil(n / self.batch_size))

    def _batches(self) -> Iterator[list[int]]:
        idx = self._epoch_indices()
        nb = len(self)
        for b in range(nb):
            chunk = idx[b * self.batch_size : (b + 1) * self.batch_size]
            if len(chunk) == 0:
                return
            yield chunk.tolist()

    def __iter__(self) -> Iterator[dict[str, Any]]:
        from concurrent.futures import ThreadPoolExecutor

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put_checked(item) -> bool:
            """Bounded put that re-checks `stop` so an early-exiting consumer
            (e.g. an eval loop breaking after N batches) never strands us."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                    for chunk in self._batches():
                        if stop.is_set():
                            return
                        samples = list(pool.map(self.dataset.__getitem__, chunk))
                        if not put_checked(self.collate_fn(samples)):
                            return
                put_checked(None)
            except BaseException as e:  # surface worker errors to the consumer
                put_checked(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
