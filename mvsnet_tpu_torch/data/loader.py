"""Prefetching batch loader (a copy of mvsnet_tpu/data/loader.py).

Replaces the reference's tf.data.from_generator + parallel_interleave +
prefetch stack (reference: train.py:209-246) with a plain thread pool that
decodes clusters concurrently on the host while the device computes, and a
bounded prefetch queue. No TF dependency.

Concurrency model: when the source exposes the per-cluster work API
(`.clusters` + `.cluster_samples`, data/generator.py), `workers` threads
each decode one cluster at a time and push finished samples to the queue in
COMPLETION order — the same "sloppy" semantics as the reference's
`parallel_interleave(sloppy=True)` (reference: train.py:240-245): decode
stragglers never stall the device feed, at the cost of a nondeterministic
sample order. Plain iterables fall back to a single producer thread.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor, wait
from typing import Iterable, Iterator, Optional

import numpy as np


def batch_iterator(sample_iter: Iterable, batch_size: int) -> Iterator:
    """Stack consecutive sample tuples into batched numpy arrays."""
    batch = []
    for sample in sample_iter:
        batch.append(sample)
        if len(batch) == batch_size:
            yield tuple(
                np.stack([b[i] for b in batch], axis=0)
                if isinstance(batch[0][i], np.ndarray)
                else np.asarray([b[i] for b in batch])
                for i in range(len(batch[0])))
            batch = []


class PrefetchingLoader:
    """Iterate `generator` with `workers` decode threads and a bounded
    prefetch queue (the host-side analogue of parallel_interleave +
    prefetch, reference: train.py:230-246).

    Args:
      generator_factory: () -> iterable of sample tuples; a fresh instance
        is created per epoch. ClusterGenerator instances get true
        multi-worker decode; any other iterable runs single-producer.
      batch_size: samples stacked per yielded batch.
      workers: concurrent cluster-decode threads (>=2 enables the pool).
      prefetch: decoded samples buffered ahead of the consumer.
      epochs: passes over the data (None = endless).
    """

    _SENTINEL = object()

    def __init__(self, generator_factory, batch_size: int = 1, workers: int = 2,
                 prefetch: int = 2, epochs: Optional[int] = None):
        self.generator_factory = generator_factory
        self.batch_size = batch_size
        self.workers = max(1, int(workers))
        self.prefetch = max(1, int(prefetch))
        self.epochs = epochs

    # -- sample producers ----------------------------------------------------

    def _produce_serial(self, factory, q, stop):
        try:
            epoch = 0
            while not stop.is_set() and (self.epochs is None or epoch < self.epochs):
                gen = factory()
                it = gen.iterate_once() if hasattr(gen, "iterate_once") else iter(gen)
                for sample in it:
                    if stop.is_set():
                        return
                    if not self._put(q, sample, stop):
                        return
                epoch += 1
        finally:
            self._put(q, self._SENTINEL, stop, force=True)

    def _produce_pooled(self, factory, q, stop):
        """Cluster-parallel decode: a pool of `workers` threads each decodes
        one cluster and pushes its samples in completion ("sloppy") order.
        Backpressure comes from the bounded queue — each worker blocks on
        put() once `prefetch` samples are buffered."""

        def decode(gen, cluster):
            if stop.is_set():
                return
            for sample in gen.cluster_samples(cluster):
                if not self._put(q, sample, stop):
                    return

        try:
            with ThreadPoolExecutor(max_workers=self.workers) as pool:
                epoch = 0
                while not stop.is_set() and (self.epochs is None or epoch < self.epochs):
                    gen = factory()
                    futures = [pool.submit(decode, gen, c) for c in gen.clusters]
                    wait(futures)
                    for f in futures:      # surface decode-thread crashes
                        exc = f.exception()
                        if exc is not None:
                            raise exc
                    epoch += 1
        finally:
            self._put(q, self._SENTINEL, stop, force=True)

    def _put(self, q, item, stop, force: bool = False) -> bool:
        """Bounded put that gives up when the consumer is gone."""
        while True:
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                if stop.is_set() and not force:
                    return False

    # -- consumer --------------------------------------------------------

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        probe = self.generator_factory()
        pooled = (self.workers > 1
                  and hasattr(probe, "clusters")
                  and hasattr(probe, "cluster_samples"))
        producer = self._produce_pooled if pooled else self._produce_serial
        # the probe instance is reused for epoch 0 by wrapping the factory
        first = [probe]

        def factory():
            if first:
                return first.pop()
            return self.generator_factory()

        t = threading.Thread(target=producer, args=(factory, q, stop), daemon=True)
        t.start()

        def samples():
            while True:
                item = q.get()
                if item is self._SENTINEL:
                    return
                yield item

        try:
            yield from batch_iterator(samples(), self.batch_size)
        finally:
            stop.set()
            # drain so producers can exit
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
