"""The data pipeline (the port of ``bigdl_tpu/dataset``): samples,
batches, transformers, in-memory datasets and MNIST."""

from bigdl_tpu_torch.dataset.dataset import (DataSet, DistributedDataSet,
                                             LocalDataSet)
from bigdl_tpu_torch.dataset.minibatch import MiniBatch, SuperBatch
from bigdl_tpu_torch.dataset.sample import Sample
from bigdl_tpu_torch.dataset.transformer import (ArrayToSample,
                                                 ChainedTransformer,
                                                 DeviceFeed, FuncTransformer,
                                                 Identity, Prefetch,
                                                 SampleToMiniBatch,
                                                 ToSuperBatch, Transformer)

__all__ = ["ArrayToSample", "ChainedTransformer", "DataSet", "DeviceFeed",
           "DistributedDataSet",
           "FuncTransformer", "Identity", "LocalDataSet", "MiniBatch",
           "Prefetch", "Sample", "SampleToMiniBatch", "SuperBatch",
           "ToSuperBatch", "Transformer"]
