"""Threaded prefetching data loader (port of ``vsrlab_tpu/data/loader.py``).

* a thread pool assembles numpy batches (OpenCV and numpy release the GIL);
* the index stream is a pure function of ``(seed, epoch)``, sharded by
  contiguous slices of each global batch, so a resume can skip batches
  and continue the very stream an uninterrupted run would see;
* each batch is handed to ``device_put`` (:func:`to_device`: a pinned
  host copy sent to the card with ``non_blocking=True``) on the producer
  thread while the consumer trains on the batch before.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from vsrlab_tpu_torch.parallel.mesh import shard_slice


def to_device(device) -> Callable[[dict], dict]:
    """``batch -> batch`` of tensors on ``device``: from pinned host memory
    with ``non_blocking=True`` on a CUDA device, as they are on the CPU."""
    device = torch.device(device)

    def put(batch: dict) -> dict:
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if device.type == "cuda":
                t = t.pin_memory().to(device, non_blocking=True)
            out[k] = t
        return out

    return put


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True, num_workers: int = 4,
                 prefetch_factor: int = 2, drop_last: bool = True, seed: int = 0,
                 num_shards: int = 1, shard_index: int = 0,
                 device_put: Optional[Callable] = None):
        if batch_size % num_shards:
            raise ValueError("global batch_size must divide by num_shards")
        self.dataset = dataset
        self.global_batch = batch_size
        self.shard_rows = shard_slice(batch_size, num_shards, shard_index)
        self.shuffle, self.drop_last, self.seed = shuffle, drop_last, seed
        self.num_workers, self.prefetch = max(1, num_workers), max(1, prefetch_factor)
        self.device_put = device_put
        self._epoch = 0
        self._skip = 0

    def set_epoch(self, epoch: int):
        self._epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def _collate(self, samples) -> dict:
        return {"lr": np.stack([s[0] for s in samples]), "hr": np.stack([s[1] for s in samples])}

    def skip_next(self, n_batches: int):
        """Skip the first ``n_batches`` of the next iteration only (a
        step-granular resume)."""
        self._skip = int(n_batches)

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.global_batch if self.drop_last else -(-n // self.global_batch)

    def _index_stream(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            order = np.random.default_rng((self.seed, self._epoch)).permutation(n)
        usable = (n // self.global_batch) * self.global_batch if self.drop_last else n
        skip, self._skip = self._skip, 0  # consume a pending skip_next
        for k, b0 in enumerate(range(0, usable, self.global_batch)):
            if k < skip:
                continue
            idx = order[b0 : b0 + self.global_batch]
            if len(idx) < self.global_batch:
                # the tail batch (drop_last=False) is wrap-padded so that
                # every shard's slice stays full
                idx = np.concatenate([idx, order[: self.global_batch - len(idx)]])
            yield idx[self.shard_rows]

    def __iter__(self) -> Iterator:
        batches = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        error: list = []

        def _put(item) -> bool:
            """A bounded put that re-checks ``stop``, so a consumer that
            stops early never leaves the producer blocked."""
            while not stop.is_set():
                try:
                    batches.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for idx in self._index_stream():
                        if stop.is_set():
                            return
                        batch = self._collate(list(pool.map(self.dataset.__getitem__, idx)))
                        if self.device_put is not None:
                            batch = self.device_put(batch)
                        if not _put(batch):
                            return
            except Exception as e:  # handed to the consumer, which raises it
                error.append(e)
            finally:
                _put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                batch = batches.get()
                if batch is None:
                    if error:
                        raise error[0]
                    return
                yield batch
        finally:
            stop.set()
            thread.join()
