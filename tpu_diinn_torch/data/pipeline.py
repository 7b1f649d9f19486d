"""Batching and prefetch for SR training and eval.

Counterpart of ``tpu_diinn/data/pipeline.py`` on one process:

- a training epoch is a permutation of ``len(dataset) * repeat`` indices
  drawn from ``SeedSequence([seed, epoch])``, cut to whole batches
  (``drop_last``) and collated to ``{scale: (lr[B, ...], hr[B, ...])}``;
- eval is batch-1 full images in dataset order.

Each sample draws from its own generator, ``SeedSequence([seed, epoch,
global index])``, so a sample's bytes do not depend on the worker that
makes it, and at most a bounded number of samples is in flight. Training
samples are made by worker processes (spawned, one pool per epoch): the
training step launches thousands of CUDA kernels from Python, each of
which releases and retakes the GIL, and loader threads holding the GIL
for PNG unfiltering and numpy work stretched a flagship step about
tenfold on the card. Eval samples, one image at a time between long
decodes, are made by a small thread pool. A script that iterates
``train_batches`` keeps its entry point under ``if __name__ ==
"__main__"``: spawned workers import the main module. The JAX pipeline's
host sharding waits for the data-parallel port (ROADMAP).
"""

from __future__ import annotations

import multiprocessing
from collections import deque
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

Batch = Dict[float, Tuple[np.ndarray, np.ndarray]]
WORKERS = 4


def _sample_rng(seed: int, epoch: int, index: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([seed, epoch, index]))


def _bounded_map(pool, fn, items, bound: int):
    """Ordered ``pool.map`` with at most ``bound`` tasks in flight."""
    items = list(items)
    inflight: deque = deque()
    nxt = 0
    try:
        while nxt < len(items) or inflight:
            while nxt < len(items) and len(inflight) < bound:
                inflight.append(pool.submit(fn, items[nxt]))
                nxt += 1
            yield inflight.popleft().result()
    finally:
        for f in inflight:
            f.cancel()


_worker_dataset = None     # the dataset, in a training worker process


def _init_worker(dataset) -> None:
    global _worker_dataset
    _worker_dataset = dataset


def _load_sample(job):
    index, seed, epoch, gidx = job
    return _worker_dataset.sample(index, _sample_rng(seed, epoch, gidx))


def train_batches(dataset, *, batch_size: int, epoch: int, seed: int = 123,
                  repeat: int = 1, num_workers: int = 8) -> Iterator[Batch]:
    """Shuffled, repeated, prefetched training batches; the last partial
    batch is dropped. ``num_workers`` worker processes make the samples;
    they are stopped when the iterator finishes or is closed."""
    n = len(dataset) * repeat
    order = np.random.default_rng(
        np.random.SeedSequence([seed, epoch])).permutation(n)
    order = order[:(n // batch_size) * batch_size]
    jobs = [(int(g) % len(dataset), seed, epoch, int(g)) for g in order]
    workers = max(1, num_workers)
    with ProcessPoolExecutor(
            max_workers=workers,
            mp_context=multiprocessing.get_context("spawn"),
            initializer=_init_worker, initargs=(dataset,)) as pool:
        buf = []
        for sample in _bounded_map(pool, _load_sample, jobs,
                                   max(2 * workers, 2 * batch_size)):
            buf.append(sample)
            if len(buf) == batch_size:
                yield _collate(buf)
                buf = []


def _collate(samples) -> Batch:
    return {
        s: (np.stack([smp[s][0] for smp in samples]).astype(np.float32),
            np.stack([smp[s][1] for smp in samples]).astype(np.float32))
        for s in samples[0]
    }


def eval_batches(dataset, indices: Optional[range] = None
                 ) -> Iterator[Tuple[int, dict]]:
    """Full-image, batch-1 eval samples in dataset order:
    ``(i, {scale: (lr[1,h,w,3], hr[1,H,W,3], name)})``. Eval samples draw
    no random numbers."""
    idxs = list(indices if indices is not None else range(len(dataset)))

    def load(i):
        return i, dataset.sample(i)

    with ThreadPoolExecutor(max_workers=WORKERS) as pool:
        for i, sample in _bounded_map(pool, load, idxs, 2 * WORKERS):
            yield i, {s: (lr[None], hr[None], name)
                      for s, (lr, hr, name) in sample.items()}
