"""Device-resident batching: the split lives on the device, a step gathers
its batch there.

Counterpart of ``distributedpytorch_tpu/data/pipeline.py::ResidentLoader``
(:40-102) at world 1: the split's uint8 images and labels are moved to the
device once, ``epoch_plan(epoch)`` is the sampler's (steps, B) index and
valid arrays on the device, and ``epoch`` gathers each step's rows there
with ``index_select``.  The host's only per-epoch work is the sampler's
permutation.  The streaming loader is not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .datasets import Split
from .sampler import ShardedSampler


class ResidentLoader:
    """One split on one device, batched by ``ShardedSampler`` (world 1)."""

    def __init__(self, split: Split, batch_size: int, shuffle: bool,
                 seed: int, device: torch.device | str):
        self.device = torch.device(device)
        self.batch_per_replica = int(batch_size)
        self.world = 1
        self.images = torch.from_numpy(np.ascontiguousarray(
            split.images)).to(self.device)
        self.labels = torch.from_numpy(split.labels.astype(np.int64)).to(
            self.device)
        self.sampler = ShardedSampler(num_samples=len(split), world_size=1,
                                      rank=0, batch_size=batch_size,
                                      shuffle=shuffle, seed=seed)
        self.batches_per_epoch = self.sampler.batches_per_epoch

    def __len__(self) -> int:
        return self.batches_per_epoch

    @property
    def global_batch(self) -> int:
        return self.world * self.batch_per_replica

    def epoch_plan(self, epoch: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(idx int64, valid bool) device tensors of shape (steps, B)."""
        idx, valid = self.sampler.epoch_indices(epoch)
        return (torch.from_numpy(idx.astype(np.int64)).to(self.device),
                torch.from_numpy(valid).to(self.device))

    def epoch(self, epoch: int):
        """Yields (images u8, labels int64, valid bool) per step, gathered
        on the device."""
        idx, valid = self.epoch_plan(epoch)
        for i in range(idx.shape[0]):
            yield (self.images.index_select(0, idx[i]),
                   self.labels.index_select(0, idx[i]), valid[i])
