from bigdl_tpu_torch.nn.activation import (Identity, LogSoftMax, ReLU,
                                           Sigmoid, SoftMax, Tanh)
from bigdl_tpu_torch.nn.basic import Reshape
from bigdl_tpu_torch.nn.containers import (Bottle, Concat, ConcatTable,
                                           Container, MapTable, ParallelTable,
                                           Sequential)
from bigdl_tpu_torch.nn.conv import SpatialConvolution
from bigdl_tpu_torch.nn.criterion import (ClassNLLCriterion,
                                          CrossEntropyCriterion)
from bigdl_tpu_torch.nn.graph import Graph, Input, Node
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.module import (Module, grad_scales,
                                       regularization_loss, regularizers)
from bigdl_tpu_torch.nn.normalization import (BatchNormalization,
                                              LayerNormalization,
                                              SpatialBatchNormalization)
from bigdl_tpu_torch.nn.pooling import (SpatialAveragePooling,
                                        SpatialMaxPooling)
from bigdl_tpu_torch.nn.quantized import Int8Linear, quantize_model
from bigdl_tpu_torch.nn.table_ops import CAddTable, JoinTable, SelectTable

__all__ = ["BatchNormalization", "Bottle", "CAddTable", "ClassNLLCriterion",
           "Concat", "ConcatTable", "Container", "CrossEntropyCriterion",
           "Graph", "Identity", "Input", "Int8Linear", "JoinTable",
           "LayerNormalization", "Linear", "LogSoftMax", "MapTable",
           "Module", "Node", "ParallelTable", "ReLU", "Reshape",
           "SelectTable", "Sequential", "Sigmoid", "SoftMax",
           "SpatialAveragePooling", "SpatialBatchNormalization",
           "SpatialConvolution", "SpatialMaxPooling", "Tanh", "grad_scales",
           "quantize_model", "regularization_loss", "regularizers"]
