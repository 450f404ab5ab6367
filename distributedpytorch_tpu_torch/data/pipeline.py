"""Batching: the device-resident loader and the streaming one.

``ResidentLoader`` is the counterpart of
``distributedpytorch_tpu/data/pipeline.py::ResidentLoader`` (:40-108): the
split's uint8 images and labels are moved to the rank's device once
(every rank holds the whole split, as the JAX package replicates it over
the mesh), ``epoch_plan(epoch)`` is this rank's ``ShardedSampler`` (steps,
B) index and valid arrays on the device (``epoch_plan_many``: several
epochs' plans one after another), and ``epoch`` gathers each step's rows
there with ``index_select``.  The host's only per-epoch work is the
sampler's permutation.

``ShardedLoader`` is the counterpart of the JAX ``ShardedLoader``
(:121-667): the split stays in host memory, a step's rows are gathered on
the host (``index_select`` into page-locked memory on the card's side,
which lets other threads run) and copied to the device asynchronously on
a side stream, and the consumer's stream waits for the copy's event.  The
lookahead (``prefetch``), the background gathering threads
(``producer_threads``) and the one ordered transfer thread
(``device_prefetch``) keep the JAX meanings; every setting yields the
same batches, byte for byte and in order, as the resident loader.  A
pinned buffer is never refilled while its copy is in flight: each batch
takes a fresh one from PyTorch's caching host allocator, which hands a
block out again only after the events of the copies that read it have
completed; the device tensors are marked used on the consumer's stream
(``record_stream``).  On the CPU the copy is the identity and the threads
and queues run as on the card.  ``reshard`` builds the loader of a new
elastic world, and the ``data.host_batch`` fault site wraps the host
gather only while a fault plan targets it (``_host_batch_fn``).

Both loaders shard alike.  Rank r of W takes the sampler's strided slice
r::W, so the global batch of a step is rank-major, rows [r*B, (r+1)*B)
from rank r, as the JAX ``_host_plan`` concatenates it (:85-89).  Under
``--model-parallel M`` (and ``--seq-parallel S``) a rank's batch is its
data shard's: the JAX mesh shards the global batch over 'data' only, so
data shard d = r // (M*S) holds the slices of ranks d*M*S ...
d*M*S+M*S-1, concatenated (B*M*S rows, the same on the M*S ranks of the
shard; the loaders' ``model_parallel`` is that block's M*S).  Each step yields (images u8, labels
int64, valid bool) on the loader's device.
"""

from __future__ import annotations

import collections
import itertools
import queue as queue_mod
import threading
import time
from typing import Sequence, Tuple

import numpy as np
import torch

from .. import faults, telemetry
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
        images = split.images
        if not images.flags.writeable:
            # torch would wrap the read-only buffer, and on the CPU the
            # loader would alias it: copy, as the JAX loader's device_put
            # does
            images = images.copy()
        self.images = torch.from_numpy(np.ascontiguousarray(images)).to(
            self.device)
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


class _ProducerFailure:
    """An exception raised on a producer thread, carried to the consumer,
    which re-raises it at the step whose batch it replaced."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


class ShardedLoader:
    """One split in host memory, batched by ``ShardedSampler`` for the data
    shard of rank ``rank`` of ``world`` and copied to ``device`` a step at
    a time.

    ``prefetch`` N: batches already on their way to the device ahead of
    the consumer (0: strictly synchronous).  ``producer_threads`` N > 0:
    thread t gathers (and, without ``device_prefetch``, copies) steps t,
    t+N, ... into its own bounded queue, and the consumer round-robins the
    queues in step order.  ``device_prefetch`` N > 0: one transfer thread
    owns every copy to the device, in step order, N batches ahead, over
    the producers' host batches (or its own gathers without producers).
    Direct constructions default ``producer_threads`` to 0, the CLI to 1.
    """

    def __init__(self, split: Split, batch_size: int, shuffle: bool,
                 seed: int, device: torch.device | str, world: int = 1,
                 rank: int = 0, model_parallel: int = 1, prefetch: int = 2,
                 producer_threads: int = 0, device_prefetch: int = 0):
        self.device = torch.device(device)
        self.split = split
        self.shuffle = bool(shuffle)
        self.seed = seed
        self.model_parallel = int(model_parallel)
        self.batch_per_replica = int(batch_size)
        self.world = int(world)
        self.rank = int(rank)
        self.prefetch = max(0, int(prefetch))
        self.producer_threads = max(0, int(producer_threads))
        self.device_prefetch = max(0, int(device_prefetch))
        self.images = torch.from_numpy(np.ascontiguousarray(split.images))
        self.labels = torch.from_numpy(split.labels.astype(np.int64))
        first = self.rank - self.rank % model_parallel
        self.samplers = [
            ShardedSampler(num_samples=len(split), world_size=self.world,
                           rank=r, batch_size=batch_size, shuffle=shuffle,
                           seed=seed)
            for r in range(first, first + model_parallel)]
        self.batches_per_epoch = self.samplers[0].batches_per_epoch
        self._pin = self.device.type == "cuda"
        self._copy_stream = (torch.cuda.Stream(self.device) if self._pin
                             else None)
        # the stop event, threads and queues of each live threaded epoch
        self._active_runs: list = []
        self._runs_lock = threading.Lock()

    def __len__(self) -> int:
        return self.batches_per_epoch

    @property
    def global_batch(self) -> int:
        return self.world * self.batch_per_replica

    # -- shutdown ------------------------------------------------------------

    def _register_run(self, run: dict) -> None:
        with self._runs_lock:
            self._active_runs.append(run)

    def _unregister_run(self, run: dict) -> None:
        with self._runs_lock:
            if run in self._active_runs:
                self._active_runs.remove(run)

    @staticmethod
    def _drain(q) -> None:
        while True:
            try:
                q.get_nowait()
            except queue_mod.Empty:
                break

    @classmethod
    def _shutdown_run(cls, run: dict) -> None:
        """Stop one epoch's threads: signal, unblock a producer parked on
        a full queue, join, then drop what the join let through."""
        run["stop"].set()
        for q in run["queues"]:
            cls._drain(q)
        for th in run["threads"]:
            th.join()
        for q in run["queues"]:
            cls._drain(q)

    def release(self) -> None:
        """Stop, drain and join the threads of every live epoch."""
        with self._runs_lock:
            runs = list(self._active_runs)
            self._active_runs.clear()
        for run in runs:
            self._shutdown_run(run)

    def reshard(self, mesh) -> "ShardedLoader":
        """A fresh loader over the same split and settings for the world
        of ``mesh`` (``runtime.Mesh``): the elastic reconfigure's (JAX
        pipeline.py:280-297).  A rank's slices are a function of
        (num_samples, world, rank, seed, epoch) only, so the new loader
        enumerates exactly what a loader born at that world would.  No
        state carries over: the old world's threads and queues are
        released first."""
        self.release()
        return ShardedLoader(
            self.split, self.batch_per_replica, self.shuffle, self.seed,
            self.device,
            world=mesh.data_parallel * mesh.shard_ranks,
            rank=(mesh.data_index * mesh.shard_ranks
                  + mesh.model_index * mesh.seq_parallel + mesh.seq_index),
            model_parallel=mesh.shard_ranks, prefetch=self.prefetch,
            producer_threads=self.producer_threads,
            device_prefetch=self.device_prefetch)

    # -- one step's batch ----------------------------------------------------

    def _host_batch(self, per_rank, step: int):
        """One step's host gather: (images u8, labels int64, valid bool)
        CPU tensors, in page-locked memory when the device is the card."""
        idx = torch.from_numpy(np.concatenate(
            [ix[step] for ix, _ in per_rank]).astype(np.int64))
        valid = torch.from_numpy(np.concatenate(
            [v[step] for _, v in per_rank]))
        if self._pin:
            valid = valid.pin_memory()
        out = []
        for src in (self.images, self.labels):
            dst = torch.empty((idx.numel(),) + src.shape[1:],
                              dtype=src.dtype, pin_memory=self._pin)
            out.append(torch.index_select(src, 0, idx, out=dst))
        return out[0], out[1], valid

    def _host_batch_fn(self):
        """``self._host_batch``, or its fault-firing and retrying twin
        when the installed fault plan targets ``data.host_batch`` (JAX
        pipeline.py:313-330): resolved once an epoch, so without a plan
        the per-step path carries no fault plumbing."""
        if not faults.targets("data.host_batch"):
            return self._host_batch

        def faulty(per_rank, step):
            def attempt():
                faults.fire("data.host_batch")
                return self._host_batch(per_rank, step)

            return faults.retry(attempt, "data.host_batch")

        return faulty

    def _host_batches(self, epoch: int):
        per_rank = [s.epoch_indices(epoch) for s in self.samplers]
        host_batch = self._host_batch_fn()
        for step in range(self.batches_per_epoch):
            yield host_batch(per_rank, step)

    def _to_device(self, arrays):
        """Start the copy of a host batch: (device tensors, the copy's
        event), on the side stream; on the CPU (the tensors, None)."""
        if not self._pin:
            return tuple(arrays), None
        with torch.cuda.device(self.device), \
                torch.cuda.stream(self._copy_stream):
            out = tuple(a.to(self.device, non_blocking=True)
                        for a in arrays)
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        return out, done

    def _hand_out(self, item):
        """The consumer's side of a copy: its stream waits for the copy's
        event, and the tensors are marked used on that stream."""
        tensors, done = item
        if done is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(done)
            for t in tensors:
                t.record_stream(stream)
        return tensors

    # -- the epochs ----------------------------------------------------------

    def epoch(self, epoch: int):
        """Yields (images u8, labels int64, valid bool) per step on the
        device.  With telemetry on, the JAX counters: ``data/wait_s``
        (counter and histogram: the consumer's wait between steps, or its
        blocking on the producers' queues), ``data/warmup_s`` (the
        lookahead's first fill), ``data/batches``,
        ``data/starved_steps`` (a step handed out with nothing in flight
        behind it), ``data/queue_depth_sum`` and, under
        ``device_prefetch``, ``data/device_wait_s`` in place of
        ``data/wait_s``.  With telemetry off the loop reads no clock."""
        tel = telemetry.get()
        if self.device_prefetch > 0:
            yield from self._device_prefetch_epoch(epoch, tel)
            return
        if self.producer_threads > 0:
            yield from self._threaded_epoch(epoch, tel)
            return
        host_iter = self._host_batches(epoch)
        if self.prefetch == 0:
            if not tel.enabled:
                for arrays in host_iter:
                    yield self._hand_out(self._to_device(arrays))
                return
            wait = tel.counter("data/wait_s")
            wait_hist = tel.histogram("data/wait_s")
            batches = tel.counter("data/batches")
            while True:
                t0 = time.perf_counter()
                try:
                    item = self._to_device(next(host_iter))
                except StopIteration:
                    return
                dt = time.perf_counter() - t0
                wait.add(dt)
                wait_hist.observe(dt)
                batches.add(1)
                yield self._hand_out(item)
        queue = collections.deque()
        if not tel.enabled:
            for arrays in itertools.islice(host_iter, self.prefetch):
                queue.append(self._to_device(arrays))
            while queue:
                yield self._hand_out(queue.popleft())
                for arrays in itertools.islice(host_iter, 1):
                    queue.append(self._to_device(arrays))
            return
        wait = tel.counter("data/wait_s")
        wait_hist = tel.histogram("data/wait_s")
        batches = tel.counter("data/batches")
        starved = tel.counter("data/starved_steps")
        depth_sum = tel.counter("data/queue_depth_sum")
        t0 = time.perf_counter()
        for arrays in itertools.islice(host_iter, self.prefetch):
            queue.append(self._to_device(arrays))
        exhausted = len(queue) < self.prefetch
        # the first fill runs before the consumer asked for anything
        tel.counter("data/warmup_s").add(time.perf_counter() - t0)
        while queue:
            depth_sum.add(len(queue))
            if len(queue) == 1 and not exhausted:
                starved.add(1)
            batches.add(1)
            yield self._hand_out(queue.popleft())
            t0 = time.perf_counter()
            try:
                queue.append(self._to_device(next(host_iter)))
            except StopIteration:
                exhausted = True
            dt = time.perf_counter() - t0
            wait.add(dt)
            wait_hist.observe(dt)

    def _consume(self, run: dict, queues: list, order, wait_name: str,
                 tel):
        """The consumer's loop over a threaded epoch: step i's item from
        ``queues[order(i)]``; a producer's failure re-raised at its step;
        the run stopped, drained and joined however the loop ends."""
        enabled = tel.enabled
        if enabled:
            wait = tel.counter(wait_name)
            wait_hist = tel.histogram(wait_name)
            batches = tel.counter("data/batches")
            starved = tel.counter("data/starved_steps")
            depth_sum = tel.counter("data/queue_depth_sum")
        try:
            for step in range(self.batches_per_epoch):
                q = queues[order(step)]
                if enabled:
                    depth_sum.add(sum(x.qsize() for x in run["queues"]))
                    if q.empty():
                        starved.add(1)
                    t0 = time.perf_counter()
                    item = q.get()
                    dt = time.perf_counter() - t0
                    wait.add(dt)
                    wait_hist.observe(dt)
                    batches.add(1)
                else:
                    item = q.get()
                if isinstance(item, _ProducerFailure):
                    raise item.exc
                yield self._hand_out(item)
        finally:
            self._shutdown_run(run)
            self._unregister_run(run)

    def _start_run(self, threads: list, queues: list,
                   stop: threading.Event) -> dict:
        run = {"stop": stop, "threads": threads, "queues": queues}
        self._register_run(run)
        for th in threads:
            th.start()
        return run

    @staticmethod
    def _putter(stop: threading.Event):
        """A bounded put that gives up once the consumer is gone."""
        def put(q, item) -> None:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return
                except queue_mod.Full:
                    continue
        return put

    def _producers(self, epoch: int, stop: threading.Event, copy: bool,
                   name: str):
        """``producer_threads`` threads, thread t gathering steps t, t+N,
        ... into its bounded queue (and starting their copies when
        ``copy``): (threads, queues)."""
        n = self.producer_threads
        per_rank = [s.epoch_indices(epoch) for s in self.samplers]
        host_batch = self._host_batch_fn()
        queues = [queue_mod.Queue(maxsize=max(1, self.prefetch))
                  for _ in range(n)]
        put = self._putter(stop)

        def produce(t: int, q) -> None:
            try:
                for step in range(t, self.batches_per_epoch, n):
                    if stop.is_set():
                        return
                    batch = host_batch(per_rank, step)
                    put(q, self._to_device(batch) if copy else batch)
            except BaseException as e:      # carried to the consumer
                put(q, _ProducerFailure(e))

        threads = [threading.Thread(target=produce, args=(t, queues[t]),
                                    name=f"dpt-{name}-{epoch}-{t}",
                                    daemon=True) for t in range(n)]
        return threads, queues

    def _threaded_epoch(self, epoch: int, tel):
        """``producer_threads`` threads gather and copy; the consumer
        round-robins their queues, so the stream is the synchronous
        one."""
        stop = threading.Event()
        threads, queues = self._producers(epoch, stop, True, "producer")
        run = self._start_run(threads, queues, stop)
        n = self.producer_threads
        yield from self._consume(run, queues, lambda step: step % n,
                                 "data/wait_s", tel)

    def _device_prefetch_epoch(self, epoch: int, tel):
        """One transfer thread starts every copy, in step order, into a
        queue of ``device_prefetch`` batches, over the producers' host
        batches (its own gathers without producers)."""
        stop = threading.Event()
        put = self._putter(stop)
        dev_q = queue_mod.Queue(maxsize=self.device_prefetch)
        nb = self.batches_per_epoch
        if self.producer_threads > 0:
            threads, host_queues = self._producers(epoch, stop, False,
                                                   "gather")
            n = self.producer_threads

            def host_stream():
                for step in range(nb):
                    q = host_queues[step % n]
                    while not stop.is_set():
                        try:
                            yield q.get(timeout=0.05)
                            break
                        except queue_mod.Empty:
                            continue
                    else:
                        return
        else:
            threads, host_queues = [], []

            def host_stream():
                per_rank = [s.epoch_indices(epoch) for s in self.samplers]
                host_batch = self._host_batch_fn()
                for step in range(nb):
                    if stop.is_set():
                        return
                    yield host_batch(per_rank, step)

        def transfer() -> None:
            try:
                for item in host_stream():
                    if isinstance(item, _ProducerFailure):
                        put(dev_q, item)
                        return
                    put(dev_q, self._to_device(item))
            except BaseException as e:      # a failed copy included
                put(dev_q, _ProducerFailure(e))

        threads.append(threading.Thread(target=transfer,
                                        name=f"dpt-h2d-{epoch}",
                                        daemon=True))
        run = self._start_run(threads, [dev_q] + host_queues, stop)
        yield from self._consume(run, [dev_q], lambda step: 0,
                                 "data/device_wait_s", tel)

