from bigdl_tpu_torch.nn.activation import LogSoftMax, ReLU
from bigdl_tpu_torch.nn.basic import Reshape
from bigdl_tpu_torch.nn.conv import SpatialConvolution
from bigdl_tpu_torch.nn.criterion import (ClassNLLCriterion,
                                          CrossEntropyCriterion)
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.normalization import (BatchNormalization,
                                              LayerNormalization,
                                              SpatialBatchNormalization)
from bigdl_tpu_torch.nn.pooling import (SpatialAveragePooling,
                                        SpatialMaxPooling)
from bigdl_tpu_torch.nn.quantized import Int8Linear, quantize_model
from bigdl_tpu_torch.nn.table_ops import CAddTable

__all__ = ["BatchNormalization", "CAddTable", "ClassNLLCriterion",
           "CrossEntropyCriterion", "Int8Linear", "LayerNormalization",
           "Linear", "LogSoftMax", "ReLU", "Reshape", "SpatialAveragePooling",
           "SpatialBatchNormalization", "SpatialConvolution",
           "SpatialMaxPooling", "quantize_model"]
