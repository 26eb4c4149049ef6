"""Batched loader with multi-threaded decode and background prefetch (the
port of `gan_codes_tpu/data/loader.py`).

Replaces the reference's torch DataLoader, which ran with NO workers and NO
pinned memory (`src/utils.py:24`) — every decode blocked the GPU step. Here
JPEG decode/augment runs in a thread pool (PIL releases the GIL) while the
card computes, and batches are handed over as uint8 numpy arrays; the
trainer copies them to the card from pinned memory, non-blocking, and
normalizes them there.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np

from .dataset import CUBDataset


class Batch(dict):
    """Dict with attribute access: images (uint8 [B,H,W,3]), captions
    (int32 [B,T]), cap_lens (int32 [B]), file_names (list[str])."""

    __getattr__ = dict.__getitem__


class DataLoader:
    def __init__(self, dataset: CUBDataset, batch_size: int,
                 shuffle: bool = True, drop_last: bool = True,
                 seed: int = 123321, num_threads: int = 8,
                 prefetch: int = 2, shard_id: int = 0, num_shards: int = 1,
                 local_rank: int = 0, local_world: int = 1):
        """`shard_id`/`num_shards`: per-host input sharding for data
        parallelism (the node and the number of nodes); each host reads a
        disjoint interleaved slice of the epoch permutation, all seeded
        identically so the global epoch order is consistent, in batches
        of `batch_size`, the host batch.

        `local_rank`/`local_world`: the process's rows of each host batch,
        [local_rank * b, (local_rank + 1) * b) with b = batch_size /
        local_world; the rows' indices and per-item seeds are taken before
        decoding, so a process decodes its rows only and the processes'
        rows make up the host batch byte for byte."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_threads = num_threads
        self.prefetch = prefetch
        if not (0 <= shard_id < num_shards):
            raise ValueError(f"shard_id {shard_id} not in [0, {num_shards})")
        self.shard_id = shard_id
        self.num_shards = num_shards
        if not (0 <= local_rank < local_world):
            raise ValueError(f"local_rank {local_rank} not in "
                             f"[0, {local_world})")
        if local_world > 1 and (batch_size % local_world or not drop_last):
            raise ValueError(f"a host batch of {batch_size} does not split "
                             f"into {local_world} equal full shares")
        self.local_rank = local_rank
        self.local_world = local_world
        self._seed = seed
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Pin the shuffle/augment RNG to an epoch (DistributedSampler-style).

        Each epoch's permutation and per-item augment seeds derive from
        (seed, epoch) only, so a killed-and-resumed run at epoch k sees
        byte-identical batches to an uninterrupted run — the resume-
        equivalence guarantee the reference lacks (its shuffle stream restarts
        from scratch on every process start). The trainer calls this every
        epoch; without it, epochs auto-advance 0, 1, 2, ... from construction.
        """
        self._epoch = int(epoch)

    def _shard_size(self) -> int:
        """Items per host: floor(n / num_shards), EQUAL for every shard.

        Under data parallelism every step is a lockstep collective, so
        every process must produce the same number of batches per epoch — a
        process with one extra batch would enter a collective no peer joins
        and hang the rest. Interleaved shards naturally differ by one item when
        num_shards doesn't divide n; truncating all shards to the floor
        (torch DistributedSampler-style, minus its padding) keeps them
        identical. Single-shard loaders are unaffected (n // 1 == n)."""
        return len(self.dataset) // self.num_shards

    def __len__(self) -> int:
        n = self._shard_size()
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _load_item(self, idx: int, seed: int):
        rng = np.random.default_rng(seed)
        image = self.dataset.load_image(idx, rng)
        caption, cap_len = self.dataset.random_caption(idx, rng)
        return image, caption, cap_len, self.dataset.file_names[idx]

    def _make_batch(self, indices: np.ndarray, seeds: np.ndarray,
                    pool: ThreadPoolExecutor) -> Batch:
        items = list(pool.map(self._load_item, indices.tolist(), seeds.tolist()))
        images = np.stack([it[0] for it in items])
        captions = np.stack([it[1] for it in items]).astype(np.int32)
        cap_lens = np.asarray([it[2] for it in items], dtype=np.int32)
        names = [it[3] for it in items]
        return Batch(images=images, captions=captions, cap_lens=cap_lens,
                     file_names=names)

    def __iter__(self) -> Iterator[Batch]:
        rng = np.random.default_rng([self._seed, self._epoch])
        self._epoch += 1
        n = len(self.dataset)
        order = rng.permutation(n) if self.shuffle else np.arange(n)
        if self.num_shards > 1:
            # equal-size shards (see _shard_size): all processes get the
            # same batch count per epoch, or the lockstep step deadlocks
            order = order[self.shard_id::self.num_shards][: self._shard_size()]
        if self.drop_last:
            order = order[: (len(order) // self.batch_size) * self.batch_size]
        batches = [order[i: i + self.batch_size]
                   for i in range(0, len(order), self.batch_size)]
        # per-batch seed arrays (the final batch may be short with
        # drop_last=False, so a single (n_batches, bs) reshape can't work)
        seeds = [rng.integers(0, 2**63 - 1, size=len(b))
                 for b in batches]
        if self.local_world > 1:  # this process's rows, before decoding
            b = self.batch_size // self.local_world
            rows = slice(self.local_rank * b, (self.local_rank + 1) * b)
            batches = [x[rows] for x in batches]
            seeds = [x[rows] for x in seeds]

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()

        def producer():
            with ThreadPoolExecutor(self.num_threads) as pool:
                try:
                    for idx_batch, seed_batch in zip(batches, seeds):
                        if stop.is_set():
                            break
                        q.put(self._make_batch(idx_batch, seed_batch, pool))
                except Exception as e:  # surface decode errors to the consumer
                    q.put(e)
                finally:
                    q.put(sentinel)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            # An abandoned iterator (e.g. eval stops after eval_max_batches)
            # must not leak the producer: it may be blocked in q.put on the
            # bounded queue. Signal it, then drain until it exits so the
            # blocked put (and its sentinel) can always complete.
            stop.set()
            while thread.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    thread.join(timeout=0.05)
            thread.join()
