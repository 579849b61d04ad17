"""Async input pipeline: prefetch + double buffer to the device
(counterpart of ``srhmm_tpu/io/pipeline.py``).

The reference blocks on stdio reads inside its EM loop: every .perfil is
re-read from disk twice per utterance per iteration
(train/source/hmm-full-fs/hmm_continuous_full_fs.c:258-269, re-reads at
:259/:287).  The replacement is a double buffer: a background thread
produces the NEXT shard (loading it and/or copying it to the card) while
the main thread computes on the CURRENT shard.  With depth=2 the
steady-state cost per shard is max(load + transfer, compute) instead of
their sum.

``device_put_loader`` copies host shards to a CUDA device from pinned host
memory, non-blocking, on a side CUDA stream that the loader owns, and
records an event after each shard's copy; before the consumer sees a shard,
its current stream waits on that event and every copied tensor is marked
used on that stream (``record_stream``), so the caching allocator cannot
hand the memory out while the consumer's work is queued.

Used by train/streaming.py (EM over datasets larger than device memory:
every iteration streams all shards, statistics accumulate on the device)
and the fast train CLI's --stream-shards mode.
"""

from __future__ import annotations

from queue import Empty, Queue
from threading import Event, Thread
from typing import Callable, Sequence

import torch

from .dataset import UtteranceBatch


class PrefetchLoader:
    """Iterate over shards with background production.

    sources: a sequence of shard descriptors (anything `load_fn` accepts:
    path lists, host tensors, UtteranceBatch of host tensors, ...).
    load_fn: called on the background thread; returns the ready-to-compute
    value (do the host-to-device copy inside, so it overlaps compute too).
    depth: queue capacity; 2 = double buffer (one in compute, one in
    flight).  ready: optional, called on the consumer's thread with each
    produced value; its result is what the iterator yields.

    Exceptions on the producer thread propagate to the consumer at the
    point of iteration.  The iterator is single-pass; construct a fresh
    PrefetchLoader per epoch / EM iteration.  A consumer that stops early
    stops the producer before the iterator is closed.
    """

    def __init__(
        self,
        sources: Sequence,
        load_fn: Callable,
        depth: int = 2,
        ready: Callable | None = None,
    ) -> None:
        if depth < 1:
            raise ValueError("PrefetchLoader: depth must be >= 1")
        self.sources = list(sources)
        self.load_fn = load_fn
        self.depth = depth
        self.ready = ready

    def __len__(self) -> int:
        return len(self.sources)

    def __iter__(self):
        q: Queue = Queue(maxsize=self.depth)
        sentinel = object()
        stop = Event()
        errors: list[BaseException] = []

        def worker():
            try:
                for src in self.sources:
                    if stop.is_set():
                        return
                    q.put(self.load_fn(src))
            except BaseException as e:  # propagate to the consumer
                errors.append(e)
            finally:
                q.put(sentinel)

        t = Thread(target=worker, name="prefetch-loader", daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    t.join()
                    if errors:
                        raise errors[0]
                    return
                yield item if self.ready is None else self.ready(item)
        finally:
            stop.set()
            while t.is_alive():  # left early: drain so the producer can finish
                try:
                    q.get(timeout=0.05)
                except Empty:
                    pass


def _map_batch(b, fn):
    """fn over every tensor of an UtteranceBatch, a tuple of them (one per
    stream) or a tensor."""
    if isinstance(b, tuple):
        return tuple(_map_batch(x, fn) for x in b)
    if isinstance(b, UtteranceBatch):
        return UtteranceBatch(fn(b.features), fn(b.lengths))
    return fn(b)


def _tensors(b) -> list[torch.Tensor]:
    out: list[torch.Tensor] = []
    _map_batch(b, out.append)
    return out


def pin_batch(b):
    """The batch in pinned (page-locked) host memory: the source a
    non-blocking host-to-device copy needs."""
    return _map_batch(b, lambda t: t if t.is_pinned() else t.pin_memory())


def device_put_loader(host_batches: Sequence, depth: int = 2, device="cuda") -> PrefetchLoader:
    """PrefetchLoader over pre-loaded HOST shards (UtteranceBatch, or a tuple
    of them, of CPU tensors): the background thread only does the
    host-to-device copy, the device-memory-bound streaming case (the data
    fits host RAM, not the card).  On a CUDA device the copies run from
    pinned memory on the loader's own stream, and the consumer's stream
    waits for each shard's copy before the shard is yielded; on the CPU the
    shards are copied plainly."""
    device = torch.device(device)
    if device.type != "cuda":
        return PrefetchLoader(host_batches, lambda b: _map_batch(b, lambda t: t.to(device)), depth)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    copy_stream = torch.cuda.Stream(device)

    def put(b):
        torch.cuda.set_device(device)  # the producer thread's own CUDA device
        with torch.cuda.stream(copy_stream):
            out = _map_batch(pin_batch(b), lambda t: t.to(device, non_blocking=True))
            copied = torch.cuda.Event()
            copied.record(copy_stream)
        return out, copied

    def ready(item):
        out, copied = item
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(copied)
        for t in _tensors(out):
            t.record_stream(consumer)
        return out

    return PrefetchLoader(host_batches, put, depth, ready=ready)
