"""Chunked writes and reads of a checkpoint directory's ``state/`` on
``torch.distributed.checkpoint`` (DCP), for ``checkpoint.py``'s
``--ckpt-format orbax``.

``write``: a rank hands DCP its own chunks of the full tensors, each with
its offsets and the full tensor's shape (``parallel.Placement.chunk``),
and its picklable values; DCP's global plan keeps one copy of an entry
that several ranks hold alike (a replicated tensor, a data group's copy
of a slice), each rank writes its share into a file of its own and the
coordinator writes ``.metadata``.  ``read``: for each entry, the boxes of
the saved tensor that this rank wants, each with the tensor it lands in;
only the saved chunks that overlap them are read, by this rank alone (no
collective).  ``entries`` is the saved metadata: an entry's shape, dtype
and chunks, read before any tensor.

Imported only where a directory is written or read: DCP takes over a
second to import.
"""

from __future__ import annotations

import contextlib
import io
import warnings
from typing import Dict, List, Tuple

import torch
import torch.distributed.checkpoint as dcp
from torch.distributed.checkpoint.default_planner import DefaultSavePlanner
from torch.distributed.checkpoint.metadata import (ChunkStorageMetadata,
                                                   MetadataIndex,
                                                   TensorProperties,
                                                   TensorStorageMetadata)
from torch.distributed.checkpoint.planner import (LoadItemType, LoadPlan,
                                                  LoadPlanner, ReadItem,
                                                  SavePlan, TensorWriteData,
                                                  WriteItem, WriteItemType)

CheckpointException = dcp.CheckpointException

# fqn -> (this rank's chunk, its offsets, the full shape)
Chunks = Dict[str, Tuple[torch.Tensor, tuple, tuple]]
# fqn -> [(the tensor a box lands in, the box's offsets in the saved one)]
Boxes = Dict[str, List[Tuple[torch.Tensor, list]]]


class _ChunkSavePlanner(DefaultSavePlanner):
    """Every rank's write items are its own chunks and values; the
    default global plan dedups and builds the metadata."""

    def __init__(self, chunks: Chunks, values: dict):
        super().__init__(flatten_state_dict=False,
                         flatten_sharded_tensors=False)
        self._chunks, self._values = chunks, values

    def create_local_plan(self) -> SavePlan:
        items = []
        for fqn, (t, offsets, shape) in self._chunks.items():
            chunk = ChunkStorageMetadata(offsets=torch.Size(offsets),
                                         sizes=t.size())
            items.append(WriteItem(
                index=MetadataIndex(fqn, torch.Size(offsets)),
                type=WriteItemType.SHARD,
                tensor_data=TensorWriteData(
                    chunk=chunk,
                    properties=TensorProperties.create_from_tensor(t),
                    size=torch.Size(shape))))
        items += [WriteItem(index=MetadataIndex(fqn),
                            type=WriteItemType.BYTE_IO)
                  for fqn in self._values]
        self.plan = SavePlan(items)
        return self.plan

    def lookup_object(self, index: MetadataIndex):
        if index.fqn in self._chunks:
            return self._chunks[index.fqn][0]
        return self._values[index.fqn]


class _BoxLoadPlanner(LoadPlanner):
    """Read items for the overlap of each wanted box with each saved
    chunk; values unpickled as they arrive."""

    def __init__(self, boxes: Boxes, values: List[str]):
        self._boxes, self._wanted = boxes, values
        self._targets: List[torch.Tensor] = []
        self.values: dict = {}

    def set_up_planner(self, state_dict, metadata=None,
                       is_coordinator: bool = False) -> None:
        self.metadata = metadata

    def create_local_plan(self) -> LoadPlan:
        items = []
        for fqn, boxes in self._boxes.items():
            chunks = self.metadata.state_dict_metadata[fqn].chunks
            for target, off in boxes:
                self._targets.append(target)
                for c in chunks:
                    lo = [max(a, b) for a, b in zip(off, c.offsets)]
                    hi = [min(a + n, b + s) for a, n, b, s in
                          zip(off, target.shape, c.offsets, c.sizes)]
                    if any(a >= b for a, b in zip(lo, hi)):
                        continue
                    items.append(ReadItem(
                        type=LoadItemType.TENSOR,
                        dest_index=MetadataIndex(fqn, torch.Size(off),
                                                 len(self._targets) - 1),
                        dest_offsets=torch.Size(
                            [a - b for a, b in zip(lo, off)]),
                        storage_index=MetadataIndex(fqn, c.offsets),
                        storage_offsets=torch.Size(
                            [a - b for a, b in zip(lo, c.offsets)]),
                        lengths=torch.Size([b - a for a, b in zip(lo, hi)])))
        zero = torch.Size([0])
        items += [ReadItem(type=LoadItemType.BYTE_IO,
                           dest_index=MetadataIndex(fqn), dest_offsets=zero,
                           storage_index=MetadataIndex(fqn),
                           storage_offsets=zero, lengths=zero)
                  for fqn in self._wanted]
        return LoadPlan(items)

    def create_global_plan(self, global_plan):
        return global_plan

    def finish_plan(self, new_plan):
        return new_plan

    def load_bytes(self, read_item: ReadItem, value: io.BytesIO) -> None:
        self.values[read_item.dest_index.fqn] = torch.load(
            value, weights_only=True)

    def resolve_tensor(self, read_item: ReadItem) -> torch.Tensor:
        t = self._targets[read_item.dest_index.index]
        for d, (o, n) in enumerate(zip(read_item.dest_offsets,
                                       read_item.lengths)):
            t = t.narrow(d, o, n)
        return t

    def commit_tensor(self, read_item: ReadItem,
                      tensor: torch.Tensor) -> None:
        pass


@contextlib.contextmanager
def _quiet():
    """DCP warns that a world of one is "assuming the intent" of a
    single-process save or load, which is what ``no_dist`` asks for."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is "
                                "disabled")
        yield


def write(state_dir: str, chunks: Chunks, values: dict,
          no_dist: bool) -> None:
    """This rank's part of a DCP save into ``state_dir`` (a collective of
    the world unless ``no_dist``)."""
    with _quiet():
        dcp.save({}, storage_writer=dcp.FileSystemWriter(state_dir),
                 planner=_ChunkSavePlanner(chunks, values), no_dist=no_dist)


def entries(state_dir: str) -> dict:
    """fqn -> the saved entry's metadata (``TensorStorageMetadata``: its
    ``size``, ``properties.dtype`` and ``chunks``; else a value)."""
    return dcp.FileSystemReader(state_dir).read_metadata(
    ).state_dict_metadata


def is_tensor(entry) -> bool:
    return isinstance(entry, TensorStorageMetadata)


def read(state_dir: str, boxes: Boxes, values: List[str]) -> dict:
    """Fill every box of ``boxes`` from ``state_dir``, on this rank
    alone; returns the unpickled ``values``."""
    planner = _BoxLoadPlanner(boxes, values)
    with _quiet():
        dcp.load({}, storage_reader=dcp.FileSystemReader(state_dir),
                 planner=planner, no_dist=True)
    return planner.values
