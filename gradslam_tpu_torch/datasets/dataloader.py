"""Threaded, prefetching batch loader (host-side IO runtime; the JAX
package's loader with ``to_device`` on torch).

Dataset ``__getitem__`` is numpy + native C++ decode
(datasets/native_loader.py releases the GIL during PNG/JPEG work), so
threads overlap IO/decode with device compute without process-spawn or
pickling costs, and ``prefetch`` keeps batches ready ahead of the
training/SLAM loop.

    loader = DataLoader(TUM(root, seqlen=10), batch_size=2, shuffle=True,
                        num_workers=4, to_device="cuda")
    for colors, depths, K, poses, *rest in loader:
        slam_sequence(colors, depths, K, ...)
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

__all__ = ["DataLoader", "default_collate"]


def default_collate(samples: Sequence):
    """Stacks a list of dataset samples into one batch.

    Each sample is a tuple (the dataset's per-index return); array-like
    fields stack along a new leading batch dim, everything else (names,
    timestamp lists, ...) collates to a list.
    """
    if not samples:
        raise ValueError("cannot collate an empty sample list")
    fields = list(zip(*samples))
    out = []
    for f in fields:
        first = f[0]
        if isinstance(first, np.ndarray) or isinstance(
            first, (int, float, np.number)
        ):
            out.append(np.stack(f))
        else:
            out.append(list(f))  # names, timestamp tuples, ...
    return tuple(out)


class DataLoader:
    """Iterates a dataset in shuffled, collated, prefetched batches.

    Args:
        dataset: any indexable with ``__len__`` returning sample tuples
            (TUM / ICL / Scannet, or anything matching that protocol).
        batch_size: samples per batch.
        shuffle: reshuffle indices each epoch (deterministic per
            ``seed`` + epoch counter).
        seed: base RNG seed for shuffling.
        drop_last: drop the trailing partial batch (default True — static
            batch shapes avoid XLA recompiles).
        num_workers: threads fetching samples concurrently (0 = fetch on
            the iterator thread).
        prefetch: max batches assembled ahead of consumption.
        to_device: a device (``"cuda"``, ``"cpu"``, ``True`` for the
            default ``"cuda"``) to move the stacked arrays to as they are
            produced, as torch tensors; False keeps numpy arrays. A CUDA
            copy goes through pinned host memory on a copy stream of its
            own, so it overlaps the device's compute.
        collate_fn: override :func:`default_collate`.
    """

    def __init__(
        self,
        dataset,
        batch_size: int = 1,
        shuffle: bool = False,
        seed: int = 0,
        drop_last: bool = True,
        num_workers: int = 2,
        prefetch: int = 2,
        to_device=False,
        collate_fn=None,
    ):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.prefetch = max(1, prefetch)
        self.device = None
        if to_device is not False and to_device is not None:
            from ..utils.device import resolve_device

            self.device = resolve_device(None if to_device is True else to_device)
        self.collate_fn = collate_fn or default_collate
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _batch_indices(self):
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self._epoch)
            rng.shuffle(idx)
        stop = (n // self.batch_size) * self.batch_size if self.drop_last else n
        return [
            idx[s : s + self.batch_size]
            for s in range(0, stop, self.batch_size)
            if not self.drop_last or s + self.batch_size <= n
        ]

    def _assemble(self, indices, pool: Optional[ThreadPoolExecutor]):
        if pool is not None:
            samples = list(pool.map(self.dataset.__getitem__, indices))
        else:
            samples = [self.dataset[i] for i in indices]
        batch = self.collate_fn(samples)
        if self.device is not None:
            batch = tuple(
                self._put(b) if isinstance(b, np.ndarray) else b
                for b in batch
            )
        return batch

    def _put(self, array: np.ndarray) -> torch.Tensor:
        """One array on the loader's device: a CUDA copy is staged in
        pinned memory and made on the copy stream, which this (producer)
        thread then waits for, so the tensor is ready when it is queued."""
        host = torch.from_numpy(np.ascontiguousarray(array))
        if self.device.type != "cuda":
            return host.to(self.device)
        with torch.cuda.stream(self._copy_stream):
            out = host.pin_memory().to(self.device, non_blocking=True)
        self._copy_stream.synchronize()
        return out

    def __iter__(self) -> Iterator:
        batches = self._batch_indices()
        self._epoch += 1
        if not batches:
            return iter(())

        pool = (
            ThreadPoolExecutor(max_workers=self.num_workers)
            if self.num_workers > 0
            else None
        )
        if self.device is not None and self.device.type == "cuda":
            self._copy_stream = torch.cuda.Stream(self.device)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        _END = object()

        def producer():
            try:
                for b in batches:
                    q.put(self._assemble(b, pool))
            except BaseException as e:  # surfaced on the consumer side
                q.put(e)
            finally:
                q.put(_END)

        t = threading.Thread(target=producer, daemon=True)
        t.start()

        def gen():
            try:
                while True:
                    item = q.get()
                    if item is _END:
                        break
                    if isinstance(item, BaseException):
                        raise item
                    if self.device is not None and self.device.type == "cuda":
                        # the tensors were allocated on the copy stream: mark
                        # them used by the consumer's stream, so their memory
                        # is not handed to a later copy while it still runs
                        consumer = torch.cuda.current_stream(self.device)
                        for b in item:
                            if torch.is_tensor(b):
                                b.record_stream(consumer)
                    yield item
            finally:
                if pool is not None:
                    pool.shutdown(wait=False, cancel_futures=True)

        return gen()
