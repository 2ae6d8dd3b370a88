"""Batched, prefetching data loader with thread or process workers (port
of ``radet_tpu/data/loader.py``, numpy only).

Every batch has one static shape, so there is no aspect-ratio grouping;
sharding is plain index striding (shard ``p`` of ``P`` takes indices
``p, p+P, ...`` of each epoch's seeded permutation).

Worker modes:

- ``'thread'`` (default): a ThreadPoolExecutor; numpy releases the GIL in
  the heavy parts and threads cost nothing to start;
- ``'process'``: spawned processes for transforms with real Python work.
  Each task is seeded from (seed, epoch, index), so augmentation is
  reproducible and independent of the worker count.  Thread mode shares
  the process's generators, so its draws depend on scheduling.

The loader yields dicts of stacked numpy arrays; the trainer stages each
batch on the device (``engine.train_step.batch_to_device``).
"""

from __future__ import annotations

import multiprocessing
import queue
import random as pyrandom
import threading
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Dict, Iterator, List

import numpy as np


def collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    keys = samples[0].keys()
    return {k: np.stack([s[k] for s in samples], axis=0) for k in keys}


_WORKER_DATASET = None


def _process_worker_init(ds_bytes: bytes):
    global _WORKER_DATASET
    import pickle

    _WORKER_DATASET = pickle.loads(ds_bytes)


def _process_worker_get(idx: int, task_seed: int):
    np.random.seed(task_seed)
    pyrandom.seed(task_seed)
    return _WORKER_DATASET[idx]


def _task_seed(seed: int, epoch: int, idx: int) -> int:
    return (seed * 1_000_003 + epoch * 131_071 + idx) % (2 ** 31 - 1)


class DataLoader:
    """Iterates batches; infinite (reshuffled epochs) when ``infinite``.

    Sharding: shard p of P sees indices p, p+P, p+2P, ... of the
    (epoch-seeded) permutation, as a rank-sharded DistributedSampler does.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        num_workers: int = 8,
        seed: int = 0,
        shard_id: int = 0,
        num_shards: int = 1,
        drop_last: bool = True,
        infinite: bool = False,
        prefetch_batches: int = 2,
        worker_mode: str = "thread",
    ):
        if worker_mode not in ("thread", "process"):
            raise ValueError(f"worker_mode must be 'thread' or 'process', got {worker_mode!r}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.drop_last = drop_last
        self.infinite = infinite
        self.prefetch_batches = prefetch_batches
        self.worker_mode = worker_mode

    def _epoch_indices(self, epoch: int) -> List[int]:
        n = len(self.dataset)
        idx = list(range(n))
        if self.shuffle:
            rng = np.random.RandomState(self.seed + epoch)
            rng.shuffle(idx)
        # pad (cycling) so every shard sees the same number of samples —
        # even when num_shards > len(dataset), where a single doubling of
        # idx would leave later shards with an empty stream (and their
        # data-parallel peers waiting in a collective)
        per_shard = (len(idx) + self.num_shards - 1) // self.num_shards
        total = per_shard * self.num_shards
        reps = (total + len(idx) - 1) // len(idx)
        idx = (idx * reps)[:total]
        return idx[self.shard_id :: self.num_shards]

    def __len__(self) -> int:
        n = len(self._epoch_indices(0))
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_stream(self):
        """(epoch, index) pairs across epochs. In infinite mode epochs chain
        seamlessly, so datasets smaller than a batch still fill batches
        (with repeats)."""
        epoch = 0
        while True:
            indices = self._epoch_indices(epoch)
            if not indices:
                return
            for idx in indices:
                yield epoch, idx
            epoch += 1
            if not self.infinite:
                return

    def _make_executor(self):
        if self.worker_mode == "process":
            import pickle

            return ProcessPoolExecutor(
                max_workers=self.num_workers,
                mp_context=multiprocessing.get_context("spawn"),
                initializer=_process_worker_init,
                initargs=(pickle.dumps(self.dataset),),
            )
        return ThreadPoolExecutor(max_workers=self.num_workers)

    def _submit(self, executor, epoch: int, idx: int):
        if self.worker_mode == "process":
            return executor.submit(
                _process_worker_get, idx, _task_seed(self.seed, epoch, idx)
            )
        return executor.submit(self.dataset.__getitem__, idx)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_batches)
        stop = threading.Event()

        def producer():
            from collections import deque

            executor = self._make_executor()
            window = max(self.num_workers * 2, self.batch_size * (self.prefetch_batches + 1))
            error = None
            try:
                stream = self._index_stream()
                pending: deque = deque()
                current: list = []
                exhausted = False
                while not stop.is_set():
                    while not exhausted and len(pending) < window:
                        nxt = next(stream, None)
                        if nxt is None:
                            exhausted = True
                            break
                        pending.append(self._submit(executor, *nxt))
                    if not pending:
                        if current and not self.drop_last:
                            out_q.put(collate(current))
                        return
                    current.append(pending.popleft().result())
                    if len(current) == self.batch_size:
                        out_q.put(collate(current))
                        current = []
            except BaseException as e:  # noqa: BLE001 - re-raised in consumer
                error = e
            finally:
                # terminal put (None = clean end): must not be dropped — a
                # consumer stalled on a slow step would otherwise wait
                # forever for a lost sentinel.
                # Retry until delivered; a consumer that abandoned iteration
                # sets `stop`, which breaks the loop so the executor is not
                # leaked.
                while not stop.is_set():
                    try:
                        out_q.put(error, timeout=0.1)
                        break
                    except queue.Full:
                        pass
                executor.shutdown(wait=False, cancel_futures=True)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                batch = out_q.get()
                if batch is None:
                    return
                if isinstance(batch, BaseException):
                    raise RuntimeError("DataLoader worker failed") from batch
                yield batch
        finally:
            stop.set()
            # drain so the producer can exit
            while not out_q.empty():
                try:
                    out_q.get_nowait()
                except queue.Empty:
                    break
