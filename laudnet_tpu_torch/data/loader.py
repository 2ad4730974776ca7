"""Input pipeline: ImageFolder dataset + threaded host-side loader
(counterpart of `laudnet_tpu/data/loader.py`).

A thread-pooled prefetching loader producing NHWC numpy batches, plus a
synthetic generator for dataset-free smoke runs. The epoch order, the
per-image seeds and the shard split are the JAX package's: with
``shard=(index, count)`` the per-epoch permutation is seeded identically in
every process and padded by wrapping so every shard draws the same count
(DistributedSampler semantics).
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional, Tuple

import numpy as np

IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


class ImageFolderDataset:
    """torchvision-ImageFolder-compatible: root/<class>/<img>."""

    def __init__(self, root: str, transform: Callable):
        self.root = root
        self.transform = transform
        classes = sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d))
        )
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = []
        for c in classes:
            cdir = os.path.join(root, c)
            for fn in sorted(os.listdir(cdir)):
                if fn.lower().endswith(IMG_EXTS):
                    self.samples.append(
                        (os.path.join(cdir, fn), self.class_to_idx[c])
                    )

    def __len__(self):
        return len(self.samples)

    def load(self, index: int, seed: int) -> Tuple[np.ndarray, int]:
        from PIL import Image

        path, label = self.samples[index]
        with Image.open(path) as img:
            return self.transform(img, seed), label


def _pad_order_for_shards(order: np.ndarray, count: int) -> np.ndarray:
    """Pad the epoch order by wrapping so every shard draws the same
    number of samples (torch DistributedSampler semantics): uneven shards
    would run different batch counts and final-batch shapes, and a
    collective step would wait for the short shard forever."""
    if count <= 1 or len(order) % count == 0:
        return order
    total = -(-len(order) // count) * count
    reps = -(-total // max(len(order), 1))
    return np.tile(order, reps)[:total]


def epoch_order(n: int, seed: int, epoch: int, shuffle: bool,
                shard: Tuple[int, int]) -> np.ndarray:
    """This shard's sample indices for ``epoch``: the permutation seeded by
    ``seed + epoch`` (every process draws the same), wrap-padded to a
    multiple of the shard count, every count-th from the shard's index."""
    rng = np.random.default_rng(seed + epoch)
    order = rng.permutation(n) if shuffle else np.arange(n)
    idx, count = shard
    return _pad_order_for_shards(order, count)[idx::count]


def batch_seeds(seed: int, epoch: int, chunk: np.ndarray) -> np.ndarray:
    """Each image's augmentation seed: a function of (seed, epoch, index)
    alone, so a batch's pixels do not depend on the thread that loads it."""
    return (seed + epoch) * 1_000_003 + chunk


def prefetched(produce_batch: Callable[[int], object], n_batches: int,
               depth: int) -> Iterator:
    """Yields ``produce_batch(b)`` for b in range(n_batches), computed by a
    background thread up to ``depth`` batches ahead. An exception in the
    producer reaches the consumer, and a consumer that stops early releases
    the producer instead of leaving it blocked on a full queue."""
    q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            for b in range(n_batches):
                if stop.is_set() or not put(produce_batch(b)):
                    return
            put(None)
        except BaseException as e:  # noqa: BLE001 -- handed to the consumer
            put(e)

    t = threading.Thread(target=produce, daemon=True)
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


class DataLoader:
    """Threaded, prefetching batch loader with epoch-seeded shuffling."""

    def __init__(self, dataset: ImageFolderDataset, batch_size: int,
                 shuffle: bool = True, num_workers: int = 8,
                 drop_last: bool = True, seed: int = 0,
                 shard: Optional[Tuple[int, int]] = None,
                 prefetch: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.seed = seed
        self.shard = shard or (0, 1)
        self.prefetch = prefetch

    def __len__(self):
        idx, count = self.shard
        n = -(-len(self.dataset) // count)  # padded per-shard count
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def epoch(self, epoch: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        order = epoch_order(len(self.dataset), self.seed, epoch,
                            self.shuffle, self.shard)
        with ThreadPoolExecutor(self.num_workers) as pool:
            def batch(b):
                chunk = order[b * self.batch_size:(b + 1) * self.batch_size]
                seeds = batch_seeds(self.seed, epoch, chunk)
                results = list(pool.map(self.dataset.load, chunk.tolist(),
                                        seeds.tolist()))
                return (np.stack([r[0] for r in results]),
                        np.asarray([r[1] for r in results], np.int32))

            yield from prefetched(batch, len(self), self.prefetch)


def synthetic_batches(batch_size: int, size: int = 224, num_classes: int = 1000,
                      steps: int = 10, seed: int = 0):
    """Dataset-free batches: NHWC f32 images and int32 labels (numpy)."""
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        yield (
            rng.standard_normal((batch_size, size, size, 3)).astype(np.float32),
            rng.integers(0, num_classes, (batch_size,)).astype(np.int32),
        )
