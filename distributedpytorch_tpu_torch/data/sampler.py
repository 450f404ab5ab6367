"""Sharded sampling with torch DistributedSampler parity semantics.

A copy of ``distributedpytorch_tpu/data/sampler.py`` (``ShardedSampler``,
:31-84; numpy only): the same seed and epoch give the same (indices,
valid) plan as the JAX package.

  * one global epoch-keyed permutation, identical on every process
    (generator seeded with seed + epoch, keyed before the epoch runs);
  * pad-to-divisible by wraparound so every rank sees the same number of
    samples (torch: indices += indices[:padding]);
  * rank r takes the strided slice indices[r::world];
  * the epoch is padded up to a whole number of batches, and a validity
    mask marks the wraparound duplicates so metrics ignore them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ..utils import epoch_numpy_rng


@dataclass
class ShardedSampler:
    num_samples: int          # dataset size N
    world_size: int           # total replicas
    rank: int                 # this replica's global index
    batch_size: int           # per-replica batch
    shuffle: bool = True
    seed: int = 0
    drop_last: bool = False

    def __post_init__(self):
        if not (0 <= self.rank < self.world_size):
            raise ValueError(f"rank {self.rank} outside world "
                             f"{self.world_size}")
        per_rank = self.num_samples / self.world_size
        if self.drop_last:
            self.batches_per_epoch = int(per_rank // self.batch_size)
        else:
            self.batches_per_epoch = max(
                1, math.ceil(per_rank / self.batch_size))
        self.samples_per_rank = self.batches_per_epoch * self.batch_size

    def __len__(self) -> int:
        return self.batches_per_epoch

    def global_permutation(self, epoch: int) -> np.ndarray:
        """The all-ranks-agree permutation, padded by wraparound."""
        if self.shuffle:
            perm = epoch_numpy_rng(self.seed, epoch).permutation(
                self.num_samples)
        else:
            perm = np.arange(self.num_samples)
        total = self.samples_per_rank * self.world_size
        if total <= self.num_samples:
            return perm[:total]
        reps = math.ceil(total / self.num_samples)
        return np.tile(perm, reps)[:total]

    def epoch_indices(self, epoch: int) -> tuple[np.ndarray, np.ndarray]:
        """(indices, valid) for this rank: each (batches_per_epoch, B).
        ``valid`` is False exactly on wraparound-padding positions."""
        perm = self.global_permutation(epoch)
        total = perm.size
        flat_valid = np.ones(total, dtype=bool)
        if total > self.num_samples:
            flat_valid[self.num_samples:] = False
        mine = perm[self.rank::self.world_size]
        mine_valid = flat_valid[self.rank::self.world_size]
        return (mine.reshape(self.batches_per_epoch, self.batch_size),
                mine_valid.reshape(self.batches_per_epoch, self.batch_size))
