"""MiniBatch and SuperBatch: samples stacked into host arrays (the port's
copy of ``bigdl_tpu/dataset/minibatch.py``, reference
``dataset/MiniBatch.scala:34``).

``MiniBatch.from_samples(pad_to=n)`` pads a short batch to ``n`` rows by
repeating its last row and keeps ``real_size``, the count of genuine rows:
training trains on the repeats, as the reference does; validation masks
them out. A ``SuperBatch`` stacks K equally shaped batches on a leading
step axis, the unit of the ``steps_per_loop`` train loop.
"""

from __future__ import annotations

import numpy as np


class MiniBatch:
    def __init__(self, input, target=None, real_size=None):
        self.input = input
        self.target = target
        self.real_size = real_size if real_size is not None else len(input)

    @staticmethod
    def from_samples(samples, pad_to=None):
        feats = [s.features for s in samples]
        labels = [s.labels for s in samples if s.labels is not None]
        x = np.stack([np.asarray(f) for f in feats])
        if pad_to is not None and x.shape[0] < pad_to:
            reps = [x[-1:]] * (pad_to - x.shape[0])
            x = np.concatenate([x] + reps, axis=0)
        y = None
        if len(labels) == len(samples):
            y = np.stack([np.asarray(lb) for lb in labels])
            if y.ndim == 2 and y.shape[1] == 1:
                y = y[:, 0]
            if pad_to is not None and y.shape[0] < pad_to:
                reps = [y[-1:]] * (pad_to - y.shape[0])
                y = np.concatenate([y] + reps, axis=0)
        return MiniBatch(x, y, real_size=len(samples))

    def size(self):
        return len(self.input)

    def get_input(self):
        return self.input

    def get_target(self):
        return self.target

    def slice(self, offset, length):
        """(reference ``MiniBatch.slice``)"""
        tgt = (None if self.target is None
               else self.target[offset:offset + length])
        real = max(0, min(length, self.real_size - offset))
        return MiniBatch(self.input[offset:offset + length], tgt, real)


class SuperBatch:
    """K MiniBatches stacked along a new leading step axis: ``input`` /
    ``target`` are ``[K, batch, ...]``; ``sizes`` / ``real_sizes`` keep
    each member's row and genuine-record counts."""

    def __init__(self, input, target, sizes, real_sizes):
        self.input = input
        self.target = target
        self.sizes = list(sizes)
        self.real_sizes = list(real_sizes)

    @property
    def k(self):
        return len(self.sizes)

    @staticmethod
    def from_minibatches(batches):
        xs = [np.asarray(b.get_input()) for b in batches]
        shape0 = xs[0].shape
        for i, x in enumerate(xs):
            if x.shape != shape0:
                raise ValueError(
                    f"SuperBatch needs uniformly-shaped member batches; "
                    f"batch 0 is {shape0}, batch {i} is {x.shape} — keep "
                    "SampleToMiniBatch's default pad_last=True, or set "
                    "drop_last=True")
        targets = [b.get_target() for b in batches]
        y = (np.stack([np.asarray(t) for t in targets])
             if all(t is not None for t in targets) else None)
        return SuperBatch(np.stack(xs), y,
                          [b.size() for b in batches],
                          [b.real_size for b in batches])

    def size(self):
        """Total (padded) records across all K member batches."""
        return sum(self.sizes)

    def get_input(self):
        return self.input

    def get_target(self):
        return self.target

    def slice_steps(self, start, stop):
        """Sub-superbatch over member steps [start, stop)."""
        tgt = None if self.target is None else self.target[start:stop]
        return SuperBatch(self.input[start:stop], tgt,
                          self.sizes[start:stop],
                          self.real_sizes[start:stop])
