"""Device-resident batching: the split lives on the device, a step gathers
its batch there.

Counterpart of ``distributedpytorch_tpu/data/pipeline.py::ResidentLoader``
(:40-108): the split's uint8 images and labels are moved to the rank's
device once (every rank holds the whole split, as the JAX package
replicates it over the mesh), ``epoch_plan(epoch)`` is this rank's
``ShardedSampler`` (steps, B) index and valid arrays on the device
(``epoch_plan_many``: several epochs' plans one after another), and
``epoch`` gathers each step's rows there with ``index_select``.  Rank r of
W takes the sampler's strided slice r::W, so the global batch of a step is
rank-major, rows [r*B, (r+1)*B) from rank r, as the JAX ``_host_plan``
concatenates it (:85-89).  Under ``--model-parallel M`` a rank's batch is
its data shard's: the JAX mesh shards the global batch over 'data' only,
so data shard d = r // M holds the slices of ranks d*M ... d*M+M-1,
concatenated (B*M rows, the same on the M model ranks of the shard).  The
host's only per-epoch work is the sampler's permutation.  The streaming
loader is not ported yet.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from .datasets import Split
from .sampler import ShardedSampler


class ResidentLoader:
    """One split on one device, batched by ``ShardedSampler`` for the data
    shard of rank ``rank`` of ``world`` (rank itself at
    ``model_parallel`` 1)."""

    def __init__(self, split: Split, batch_size: int, shuffle: bool,
                 seed: int, device: torch.device | str, world: int = 1,
                 rank: int = 0, model_parallel: int = 1):
        self.device = torch.device(device)
        self.batch_per_replica = int(batch_size)
        self.world = int(world)
        self.rank = int(rank)
        self.images = torch.from_numpy(np.ascontiguousarray(
            split.images)).to(self.device)
        self.labels = torch.from_numpy(split.labels.astype(np.int64)).to(
            self.device)
        first = self.rank - self.rank % model_parallel
        self.samplers = [
            ShardedSampler(num_samples=len(split), world_size=self.world,
                           rank=r, batch_size=batch_size, shuffle=shuffle,
                           seed=seed)
            for r in range(first, first + model_parallel)]
        self.batches_per_epoch = self.samplers[0].batches_per_epoch

    def __len__(self) -> int:
        return self.batches_per_epoch

    @property
    def global_batch(self) -> int:
        return self.world * self.batch_per_replica

    def epoch_plan(self, epoch: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(idx int64, valid bool) device tensors of shape (steps, B *
        model_parallel)."""
        return self.epoch_plan_many([epoch])

    def epoch_plan_many(self, epochs: Sequence[int]
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The plans of ``epochs`` one after another: (idx, valid) of
        shape (len(epochs) * steps, B * model_parallel), moved to the
        device at once."""
        plans = [[s.epoch_indices(e) for s in self.samplers] for e in epochs]
        idx = np.concatenate([np.concatenate([ix for ix, _ in p], axis=1)
                              for p in plans])
        valid = np.concatenate([np.concatenate([v for _, v in p], axis=1)
                                for p in plans])
        return (torch.from_numpy(idx.astype(np.int64)).to(self.device),
                torch.from_numpy(valid).to(self.device))

    def epoch(self, epoch: int):
        """Yields (images u8, labels int64, valid bool) per step, gathered
        on the device."""
        idx, valid = self.epoch_plan(epoch)
        for i in range(idx.shape[0]):
            yield (self.images.index_select(0, idx[i]),
                   self.labels.index_select(0, idx[i]), valid[i])
