"""Bucketed data loader: shuffling, worker processes or threads, fixed-shape
batches (counterpart of ``detr_tpu/data/loader.py``, the target wire).

Workers decode and augment; the loader groups the augmented images by shape
bucket and emits a batch when a bucket fills.  Training drops each epoch's
remainders (``drop_last``); evaluation pads the last short batch of a bucket
by repeating its last item and says how many it added in ``pad_count`` and
``image_valid``.

Workers are processes by default: the augmentation chain is numpy and PIL
under the interpreter lock, so threads do not scale.  Processes start with
the ``"spawn"`` method, which a CUDA host needs (a forked child of a process
that has initialised CUDA cannot use it), and they never touch the card:
they load, augment and fit to a bucket, nothing more.  A dataset that does
not pickle falls back to threads, with a warning.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
from collections import deque
from typing import Iterator, Optional, Sequence

import numpy as np

from detr_tpu_torch.data.bucketing import (
    DEFAULT_BUCKETS,
    EVAL_BUCKETS,
    assemble_batch,
    fit_to_bucket,
    pick_bucket,
)

logger = logging.getLogger(__name__)

# ---- process-worker state (module level, so that "spawn" can import it) ----

_WORKER_DATASET = None
_WORKER_BUCKETS = None


def _pool_init(dataset, buckets, base_seed, counter):
    global _WORKER_DATASET, _WORKER_BUCKETS
    _WORKER_DATASET = dataset
    _WORKER_BUCKETS = buckets
    # Every worker unpickles the same dataset: without a seed of its own each
    # would replay one augmentation stream.  The seeds are base_seed + the
    # order in which workers start; which worker loads which index is the
    # pool's choice, so only num_workers=0 is reproducible image by image.
    if hasattr(dataset, "set_worker_seed"):
        with counter.get_lock():
            idx = counter.value
            counter.value += 1
        dataset.set_worker_seed(int(base_seed) + idx)


def _pool_probe() -> bool:
    return _WORKER_DATASET is not None


def _load_fitted(dataset, i, buckets):
    """Load item i, pick its bucket, fit the image into it."""
    img, target = dataset[int(i)]
    img = np.asarray(img)
    bucket_id = pick_bucket(img.shape[0], img.shape[1], buckets)
    img, target = fit_to_bucket(img, target, buckets[bucket_id])
    return bucket_id, (img, target)


def _pool_load(i: int):
    return _load_fitted(_WORKER_DATASET, i, _WORKER_BUCKETS)


class BucketedLoader:
    """Iterates fixed-shape batches over a dataset of (image, target) pairs.

    Args:
      dataset: indexable, returning (image array or PIL image, target dict),
        e.g. ``data.coco.CocoDataset``.
      batch_size: images per batch.
      buckets: (H, W) shape buckets.
      shuffle / drop_last: as torch's DataLoader.
      num_workers: decode-and-augment workers (0: in the caller's thread).
      seed: shuffle seed; epoch e shuffles with seed + e.
      prefetch: batches' worth of items in flight per worker pool.
      worker_mode: "process" (a spawn pool), "thread", or "auto" (processes
        on hosts with at least 4 cores).
      shard: (index, count): this process keeps every count-th index of the
        shuffled epoch, and every process emits the same number of batches.
      image_dtype: "float32" (normalised on the host) or "uint8" (normalised
        on the card by ``ops.image_norm``).
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        buckets: Sequence[tuple[int, int]] = DEFAULT_BUCKETS,
        max_gt: int = 100,
        shuffle: bool = True,
        drop_last: bool = True,
        num_workers: int = 2,
        seed: int = 0,
        prefetch: int = 4,
        worker_mode: str = "auto",
        shard: tuple[int, int] = (0, 1),
        image_dtype: str = "float32",
    ):
        if worker_mode == "auto":
            worker_mode = "process" if (os.cpu_count() or 1) >= 4 else "thread"
        if worker_mode not in ("process", "thread"):
            raise ValueError(f"worker_mode must be 'auto', 'process' or 'thread', got {worker_mode!r}")
        if not (0 <= shard[0] < shard[1]):
            raise ValueError(f"shard index/count {shard} invalid")
        self.dataset = dataset
        self.batch_size = batch_size
        self.buckets = tuple(buckets)
        self.max_gt = max_gt
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.seed = seed
        self.prefetch = prefetch
        self.worker_mode = worker_mode
        self.shard = shard
        self.image_dtype = image_dtype
        self.epoch = 0
        self._pool = None
        if self._batch_quota() == 0:
            # every epoch would be empty: the shard cannot promise one batch
            raise ValueError(
                f"dataset shard of {len(dataset) // shard[1]} items cannot "
                f"guarantee even one full batch per epoch across "
                f"{len(self.buckets)} buckets at batch_size {batch_size} "
                f"(needs >= {len(self.buckets) * batch_size} items/shard); "
                f"use a smaller batch, fewer buckets, or more data"
            )

    def close(self) -> None:
        """Stop the worker processes, if any."""
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # interpreter shutdown: the pool may be half gone
            pass

    def __len__(self) -> int:
        # An upper bound: drop_last strands up to batch_size - 1 items per
        # bucket, and how many depends on the epoch's augmentation.
        return len(self.dataset) // self.batch_size

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        # Every process shuffles alike and keeps a disjoint strided slice, so
        # the processes together cover the epoch once.
        index, count = self.shard
        if count > 1:
            idx = idx[index::count]
        return idx

    def _load_item(self, i: int):
        return _load_fitted(self.dataset, i, self.buckets)

    def _start_pool(self) -> bool:
        """Start the spawn pool; False if the dataset does not pickle or the
        workers do not come up."""
        import multiprocessing as mp
        import pickle

        try:
            pickle.dumps(self.dataset)
        except Exception as e:  # pickling reports many types; any means "cannot ship"
            logger.warning("dataset does not pickle (%s): loading with threads instead of "
                           "processes", e)
            return False
        ctx = mp.get_context("spawn")
        counter = ctx.Value("i", 0)
        pool = ctx.Pool(self.num_workers, initializer=_pool_init,
                        initargs=(self.dataset, self.buckets, self.seed, counter))
        # Spawn imports the parent's __main__ again, which fails for a script
        # read from stdin: such a pool would restart its workers for ever.
        try:
            ok = pool.apply_async(_pool_probe).get(timeout=60)
        except Exception as e:  # the probe's own error or a timeout
            ok = False
            logger.warning("worker processes did not start (%r)", e)
        if not ok:
            pool.terminate()
            pool.join()
            logger.warning("loading with threads instead of processes")
            return False
        self._pool = pool
        return True

    def _process_stream(self, indices) -> Iterator:
        """Items in index order from the pool, at most prefetch * batch_size
        in flight (a whole epoch submitted at once would buffer without bound
        while the consumer pauses)."""
        pool = self._pool
        index_iter = iter([int(i) for i in indices])
        pending: deque = deque()

        def submit() -> bool:
            i = next(index_iter, None)
            if i is None:
                return False
            pending.append(pool.apply_async(_pool_load, (i,)))
            return True

        for _ in range(max(1, self.prefetch) * self.batch_size):
            if not submit():
                break
        while pending:
            result = pending.popleft().get()
            submit()
            yield result

    def _thread_stream(self, indices) -> Iterator:
        in_q: queue.Queue = queue.Queue()
        out_q: queue.Queue = queue.Queue(maxsize=max(self.prefetch, 1) * self.batch_size)
        for pos, i in enumerate(indices):
            in_q.put((pos, i))
        stop = object()
        abandoned = threading.Event()
        # numpy Generators are not thread-safe: one lock around the dataset
        # (the chain holds the interpreter lock anyway).
        load_lock = threading.Lock()

        def put(item) -> None:
            # bounded, so that a consumer that walks away frees the thread
            while not abandoned.is_set():
                try:
                    out_q.put(item, timeout=0.2)
                    return
                except queue.Full:
                    continue

        def worker():
            while not abandoned.is_set():
                try:
                    pos, i = in_q.get_nowait()
                except queue.Empty:
                    put(stop)
                    return
                try:
                    with load_lock:
                        payload = self._load_item(i)
                except Exception as e:  # handed to the consumer, which raises it
                    payload = e
                put((pos, payload))

        threads = [threading.Thread(target=worker, daemon=True) for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        pending: dict[int, object] = {}
        next_pos = 0
        try:
            while next_pos < len(indices):
                item = out_q.get()
                if item is stop:
                    continue
                pos, payload = item
                pending[pos] = payload
                while next_pos in pending:  # serve in index order
                    payload = pending.pop(next_pos)
                    next_pos += 1
                    if isinstance(payload, Exception):
                        raise payload
                    yield payload
        finally:
            abandoned.set()
            try:
                while True:
                    out_q.get_nowait()
            except queue.Empty:
                pass

    def _item_stream(self, indices) -> Iterator:
        if self.num_workers <= 0:
            return (self._load_item(i) for i in indices)
        if self.worker_mode == "process" and (self._pool is not None or self._start_pool()):
            return self._process_stream(indices)
        return self._thread_stream(indices)

    def _batch_quota(self) -> Optional[int]:
        """The batches every process emits per epoch when sharded: a shard of
        n items over k buckets strands fewer than batch_size items per
        bucket, so it makes at least floor(n / B) - (k - 1) full batches."""
        _, count = self.shard
        if count <= 1 or not self.drop_last:
            return None
        n_min = len(self.dataset) // count
        return max(0, n_min // self.batch_size - (len(self.buckets) - 1))

    def _assemble(self, bucket_id: int, items: list) -> dict[str, np.ndarray]:
        return assemble_batch(items, self.buckets[bucket_id], self.max_gt,
                              image_dtype=self.image_dtype)

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        indices = self._indices()
        self.epoch += 1
        quota = self._batch_quota()
        emitted = 0
        pools: dict[int, list] = {i: [] for i in range(len(self.buckets))}
        stream = self._item_stream(indices)
        for bucket_id, item in stream:
            if quota is not None and emitted >= quota:
                for _ in stream:  # let the workers finish (a few items at most)
                    pass
                return
            pools[bucket_id].append(item)
            if len(pools[bucket_id]) == self.batch_size:
                batch = self._assemble(bucket_id, pools[bucket_id])
                batch["pad_count"] = np.int32(0)
                batch["image_valid"] = np.ones(self.batch_size, bool)
                pools[bucket_id] = []
                yield batch
                emitted += 1
        if quota is not None:
            if emitted < quota:
                raise RuntimeError(f"sharded loader emitted {emitted} < quota {quota} batches")
            return
        if not self.drop_last:
            for bucket_id, items in pools.items():
                if not items:
                    continue
                pad = self.batch_size - len(items)
                batch = self._assemble(bucket_id, items + [items[-1]] * pad)
                batch["pad_count"] = np.int32(pad)
                image_valid = np.ones(self.batch_size, bool)
                if pad:
                    image_valid[-pad:] = False
                batch["image_valid"] = image_valid
                yield batch


def make_eval_loader(
    dataset,
    batch_size: int,
    max_gt: int = 100,
    num_workers: int = 2,
    shape: tuple[int, int] | None = None,
    shard: tuple[int, int] = (0, 1),
    image_dtype: str = "float32",
) -> BucketedLoader:
    """In order, nothing dropped: the eval buckets, or ``shape`` (landscape
    (H, W), ``TrainingConfig.eval_shape``) and its transpose."""
    if shape is None:
        buckets = EVAL_BUCKETS
    else:
        h, w = tuple(shape)
        buckets = ((h, w),) if h == w else ((h, w), (w, h))
    return BucketedLoader(
        dataset,
        batch_size,
        buckets=buckets,
        max_gt=max_gt,
        shuffle=False,
        drop_last=False,
        num_workers=num_workers,
        shard=shard,
        image_dtype=image_dtype,
    )
