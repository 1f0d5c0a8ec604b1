"""DataSets (the port of ``bigdl_tpu/dataset/dataset.py``, reference
``dataset/DataSet.scala``): ``LocalDataSet`` is an in-memory list of
records under a transformer chain; ``data(train)`` yields the transformed
records, in the order of the latest ``shuffle`` when ``train``.

``shuffle(seed=None)`` draws with ``np.random.default_rng(seed)``, as the
reference does, so a seed gives the reference's order; the optimizer
calls it without a seed each epoch, so two runs differ unless the caller
pins it (the reference's behaviour, kept). A distributed dataset is
ROADMAP queue A.10.
"""

from __future__ import annotations

import copy

import numpy as np

from bigdl_tpu_torch.dataset.sample import Sample
from bigdl_tpu_torch.dataset.transformer import Identity


class AbstractDataSet:
    def __init__(self):
        self.transformer = Identity()

    def transform(self, transformer):
        new = self.copy()
        new.transformer = (self.transformer >> transformer
                           if not isinstance(self.transformer, Identity)
                           else transformer)
        return new

    def __rshift__(self, transformer):
        return self.transform(transformer)

    def size(self):
        raise NotImplementedError

    def shuffle(self, seed=None):
        raise NotImplementedError

    def data(self, train=True):
        raise NotImplementedError

    def copy(self):
        return copy.copy(self)


class LocalDataSet(AbstractDataSet):
    """In-memory dataset (reference ``DataSet.scala:113``)."""

    def __init__(self, records):
        super().__init__()
        self.records = list(records)
        self._order = np.arange(len(self.records))

    def size(self):
        return len(self.records)

    def shuffle(self, seed=None):
        rng = np.random.default_rng(seed)
        rng.shuffle(self._order)
        return self

    def data(self, train=True):
        order = self._order if train else np.arange(len(self.records))
        return self.transformer(self.records[i] for i in order)


def _refuse_distributed():
    raise NotImplementedError(
        "distributed datasets are not ported yet (ROADMAP queue A.10 "
        "DistriOptimizer)")


class DataSet:
    """Factory (reference ``object DataSet:322``)."""

    @staticmethod
    def array(records, distributed=False):
        if distributed:
            _refuse_distributed()
        return LocalDataSet(records)

    @staticmethod
    def sample_arrays(features, labels, distributed=False):
        if distributed:
            _refuse_distributed()
        return LocalDataSet(Sample.from_ndarray(f, lb)
                            for f, lb in zip(features, labels))
