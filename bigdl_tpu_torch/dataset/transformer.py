"""Transformers: lazy, composable preprocessing over iterators (the port of
``bigdl_tpu/dataset/transformer.py``, reference
``dataset/Transformer.scala:44``): ``a >> b`` composes, ``SampleToMiniBatch``
batches, ``ToSuperBatch`` stacks K batches, ``Prefetch`` runs the chain
above it on a producer thread, and ``DeviceFeed`` moves batches to the
card.

``DeviceFeed`` is the card's idiom of the reference's double-buffered
transfer: each item's arrays are staged in pinned host memory and copied
with ``non_blocking=True`` on a side stream one item ahead of
consumption, and the compute stream waits on the copy's event before it
reads the tensors, so the next batch's copy overlaps this batch's step.
``DeviceFeed.copies`` counts the tensors it has handed over (on the CPU
the arrays are wrapped without a copy, and counted the same). float64
arrays arrive as float32, as the reference's ``jnp.asarray`` makes them.
``ParallelTransformer``/``MTImageToBatch`` wait for ``transform/vision.py``
(ROADMAP queue A.11).
"""

from __future__ import annotations

import collections
import queue
import threading

import numpy as np
import torch

from bigdl_tpu_torch.dataset.minibatch import MiniBatch, SuperBatch
from bigdl_tpu_torch.dataset.sample import Sample


class Transformer:
    def apply(self, iterator):
        raise NotImplementedError

    def __call__(self, iterator):
        return self.apply(iterator)

    def then(self, other):
        return ChainedTransformer(self, other)

    def __rshift__(self, other):  # a >> b  ==  reference's a -> b
        return self.then(other)


class ChainedTransformer(Transformer):
    def __init__(self, first, second):
        self.first, self.second = first, second

    def apply(self, iterator):
        return self.second(self.first(iterator))


class Identity(Transformer):
    def apply(self, iterator):
        return iterator


class FuncTransformer(Transformer):
    """Lift a per-record function into a Transformer."""

    def __init__(self, fn):
        self.fn = fn

    def apply(self, iterator):
        return (self.fn(x) for x in iterator)


class SampleToMiniBatch(Transformer):
    """Group Samples into MiniBatches (reference
    ``dataset/Transformer.scala:309``). The tail batch is padded to
    ``batch_size`` by repetition (``pad_last``, the default), left short
    (``pad_last=False``) or dropped (``drop_last``)."""

    def __init__(self, batch_size, drop_last=False, pad_last=True):
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.pad_last = pad_last

    def apply(self, iterator):
        batch = []
        for sample in iterator:
            batch.append(sample)
            if len(batch) == self.batch_size:
                yield MiniBatch.from_samples(batch)
                batch = []
        if batch and not self.drop_last:
            yield MiniBatch.from_samples(
                batch, pad_to=self.batch_size if self.pad_last else None)


class ArrayToSample(Transformer):
    """(features, label) pairs -> Sample."""

    def apply(self, iterator):
        return (Sample.from_ndarray(f, lb) for f, lb in iterator)


class ToSuperBatch(Transformer):
    """Stack K consecutive MiniBatches into one SuperBatch (``[K, batch,
    ...]``); the epoch's tail yields a shorter one."""

    def __init__(self, k):
        if k != int(k) or int(k) < 1:
            raise ValueError(f"k must be a positive integer, got {k!r}")
        self.k = int(k)

    def apply(self, iterator):
        buf = []
        for batch in iterator:
            buf.append(batch)
            if len(buf) == self.k:
                yield SuperBatch.from_minibatches(buf)
                buf = []
        if buf:
            yield SuperBatch.from_minibatches(buf)


def _batch_arrays(item):
    return tuple(a for a in (item.get_input(), item.get_target())
                 if a is not None)


def host_tensor(a):
    """A CPU tensor over ``a``; float64 becomes float32, as the
    reference's ``jnp.asarray`` makes it."""
    a = np.asarray(a)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(a))


class DeviceFeed(Transformer):
    """Yields ``(item, tensors)``: ``tensors`` are the batch's input and
    target on ``device``, each copy issued one item before it is consumed
    (see module docstring)."""

    copies = 0

    def __init__(self, device):
        self.device = torch.device(device)

    def _issue(self, item, stream):
        host = [host_tensor(a) for a in _batch_arrays(item)]
        DeviceFeed.copies += len(host)
        if stream is None:
            return host, None
        pinned = [t.pin_memory() for t in host]
        with torch.cuda.stream(stream):
            dev = [t.to(self.device, non_blocking=True) for t in pinned]
            done = torch.cuda.Event()
            done.record(stream)
        return dev, done

    def _ready(self, staged):
        tensors, done = staged
        if done is not None:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(done)
            for t in tensors:
                t.record_stream(compute)
        return tuple(tensors)

    def apply(self, iterator):
        stream = (torch.cuda.Stream(self.device)
                  if self.device.type == "cuda" else None)
        buf = collections.deque()
        for item in iterator:
            buf.append((item, self._issue(item, stream)))
            if len(buf) > 1:
                item, staged = buf.popleft()
                yield item, self._ready(staged)
        while buf:
            item, staged = buf.popleft()
            yield item, self._ready(staged)


class Prefetch(Transformer):
    """Runs the chain above it on a background thread through a bounded
    queue; place it last: ``ds >> SampleToMiniBatch(n) >> Prefetch()``."""

    def __init__(self, buffer_size=4):
        self.buffer_size = buffer_size

    def apply(self, iterator):
        q = queue.Queue(maxsize=self.buffer_size)
        end = object()
        stop = threading.Event()

        def put(item):
            # gives up when the consumer abandoned the generator, so the
            # producer never blocks on a full queue forever
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for item in iterator:
                    if not put(item):
                        return
                put(end)
            except BaseException as e:  # surfaced on the consumer side
                put(e)

        threading.Thread(target=producer, daemon=True).start()
        try:
            while True:
                item = q.get()
                if item is end:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
