"""DataSets (the port of ``bigdl_tpu/dataset/dataset.py``, reference
``dataset/DataSet.scala``): ``LocalDataSet`` is an in-memory list of
records under a transformer chain; ``data(train)`` yields the transformed
records, in the order of the latest ``shuffle`` when ``train``.

``shuffle(seed=None)`` draws with ``np.random.default_rng(seed)``, as the
reference does, so a seed gives the reference's order; the optimizer
calls it without a seed each epoch, so two runs differ unless the caller
pins it (the reference's behaviour, kept).

``DistributedDataSet`` (``DataSet.array(records, distributed=True)``) is
the reference's per-process shard: process ``i`` of ``n`` keeps records
``j`` with ``j % n == i``, and an unseeded ``shuffle`` draws from the
epoch count (1, 2, ...), the same on every process, so two runs and the
reference see the same orders. The ``DistriOptimizer`` lays its batches
out over the replicas of its mesh. One process is driven; more than one
raises, naming ROADMAP queue A.10(b).
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


class DistributedDataSet(LocalDataSet):
    """This process's shard of a global dataset (reference
    ``DataSet.scala:167``; see module docstring): the local dataset of its
    records, shuffled from the epoch count."""

    def __init__(self, records, process_index=None, process_count=None):
        self.process_index = 0 if process_index is None else process_index
        self.process_count = 1 if process_count is None else process_count
        if self.process_count > 1:
            raise NotImplementedError(
                f"a distributed dataset over {self.process_count} processes "
                "waits for ROADMAP queue A.10(b); one process drives every "
                "replica of the mesh")
        super().__init__(list(records)[self.process_index::
                                       self.process_count])
        self._epoch_seed = 0

    def size(self):
        return len(self.records) * self.process_count

    def local_size(self):
        return len(self.records)

    def shuffle(self, seed=None):
        self._epoch_seed = self._epoch_seed + 1 if seed is None else seed
        return super().shuffle(self._epoch_seed)

    def origin_rdd(self):
        """The reference's ``originRDD()``: this process's records."""
        return self.records


class DataSet:
    """Factory (reference ``object DataSet:322``)."""

    @staticmethod
    def array(records, distributed=False):
        if distributed:
            return DistributedDataSet(records)
        return LocalDataSet(records)

    @staticmethod
    def sample_arrays(features, labels, distributed=False):
        return DataSet.array([Sample.from_ndarray(f, lb)
                              for f, lb in zip(features, labels)],
                             distributed)
