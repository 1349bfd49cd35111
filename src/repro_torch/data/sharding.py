"""Data sharding — paper §3.4 (a copy of repro/data/sharding.py, which is
numpy only; the port imports nothing of repro).

"To make sure that the mini-batch does not have redundant samples, we only
grant each worker access to a shard of the dataset. Within each shard,
random shuffling is used to construct the mini-batch samples."

This is sampling WITHOUT replacement across the global batch, giving the
variance bound O((n-k)/(k(n-1)) sigma^2) instead of O(sigma^2 / k) for
with-replacement sampling. `benchmarks/sharding_variance.py` verifies the
two bounds empirically.

The sampler is deterministic given (seed, epoch, worker): shard assignment
is a static partition; the in-shard order is a per-epoch PRNG permutation —
so every worker can compute its own indices with no coordination, exactly
like the paper's 1536-shard setup.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    num_samples: int     # n: dataset size
    num_workers: int     # number of data-parallel workers (paper: 1536)
    worker: int          # this worker's index
    seed: int = 0

    def __post_init__(self):
        assert 0 <= self.worker < self.num_workers


def shard_bounds(spec: ShardSpec) -> tuple:
    """Contiguous disjoint shard [lo, hi) for this worker."""
    per = spec.num_samples // spec.num_workers
    lo = spec.worker * per
    hi = lo + per if spec.worker < spec.num_workers - 1 else spec.num_samples
    return lo, hi


def epoch_indices(spec: ShardSpec, epoch: int) -> np.ndarray:
    """Shuffled in-shard sample indices for one epoch (without replacement)."""
    lo, hi = shard_bounds(spec)
    rng = np.random.default_rng(
        np.random.SeedSequence([spec.seed, epoch, spec.worker]))
    idx = np.arange(lo, hi)
    rng.shuffle(idx)
    return idx


def minibatches(spec: ShardSpec, per_worker_batch: int,
                start_epoch: int = 0) -> Iterator[np.ndarray]:
    """Infinite stream of per-worker index batches; epoch boundary reshuffles.

    Drops the tail remainder of each epoch (standard practice) so every
    global batch is exactly num_workers * per_worker_batch unique samples.
    """
    epoch = start_epoch
    while True:
        idx = epoch_indices(spec, epoch)
        usable = (len(idx) // per_worker_batch) * per_worker_batch
        for i in range(0, usable, per_worker_batch):
            yield idx[i:i + per_worker_batch]
        epoch += 1


def with_replacement_batch(rng: np.random.Generator, num_samples: int,
                           batch: int) -> np.ndarray:
    """Baseline sampler for the variance comparison benchmark."""
    return rng.integers(0, num_samples, size=batch)
