"""Sample: the unit record handed to optimizers (the port's copy of
``bigdl_tpu/dataset/sample.py``, reference ``dataset/Sample.scala:32``).
Features and labels are numpy arrays on the host; batches reach the card
in ``transformer.DeviceFeed``."""

from __future__ import annotations

import numpy as np


class Sample:
    __slots__ = ("features", "labels")

    def __init__(self, features, labels=None):
        self.features = features
        self.labels = labels

    @staticmethod
    def from_ndarray(features, labels=None):
        features = np.asarray(features)
        if labels is not None and not isinstance(labels, (list, tuple, dict)):
            labels = np.asarray(labels)
        return Sample(features, labels)

    def feature(self):
        return self.features

    def label(self):
        return self.labels

    def __repr__(self):
        f = getattr(self.features, "shape", None)
        lb = getattr(self.labels, "shape", None)
        return f"Sample(features={f}, labels={lb})"
