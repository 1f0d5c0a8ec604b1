from bigdl_tpu_torch.nn.activation import (Identity, LogSoftMax, ReLU,
                                           Sigmoid, SoftMax, Tanh)
from bigdl_tpu_torch.nn.basic import Dropout, Flatten, Reshape
from bigdl_tpu_torch.nn.containers import (Bottle, Concat, ConcatTable,
                                           Container, MapTable, ParallelTable,
                                           Sequential)
from bigdl_tpu_torch.nn.conv import (SpatialConvolution,
                                     SpatialDilatedConvolution)
from bigdl_tpu_torch.nn.criterion import (ClassNLLCriterion,
                                          CrossEntropyCriterion,
                                          TimeDistributedCriterion)
from bigdl_tpu_torch.nn.embedding import LookupTable, LookupTableSparse
from bigdl_tpu_torch.nn.graph import Graph, Input, Node
from bigdl_tpu_torch.nn.init_methods import (BilinearFiller, ConstInitMethod,
                                             InitializationMethod,
                                             MsraFiller, Ones, RandomNormal,
                                             RandomUniform, Xavier, Zeros)
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.module import (Module, grad_scales,
                                       regularization_loss, regularizers,
                                       takes_generator)
from bigdl_tpu_torch.nn.normalization import (BatchNormalization,
                                              LayerNormalization,
                                              SpatialBatchNormalization,
                                              SpatialCrossMapLRN)
from bigdl_tpu_torch.nn.pooling import (SpatialAveragePooling,
                                        SpatialMaxPooling)
from bigdl_tpu_torch.nn.quantized import (
    Int8Linear, QuantizedLinear, QuantizedSpatialConvolution,
    QuantizedSpatialDilatedConvolution, Quantizer, quantize_model)
from bigdl_tpu_torch.nn.recurrent import (GRU, LSTM, BiRecurrent, Cell,
                                          ConvLSTMPeephole,
                                          ConvLSTMPeephole3D, LSTMPeephole,
                                          MultiRNNCell, Recurrent,
                                          RecurrentDecoder, RnnCell,
                                          TimeDistributed)
from bigdl_tpu_torch.nn.table_ops import CAddTable, JoinTable, SelectTable
from bigdl_tpu_torch.nn.tree_lstm import BinaryTreeLSTM, TreeGather, TreeLSTM

__all__ = ["BatchNormalization", "BiRecurrent", "BilinearFiller",
           "BinaryTreeLSTM", "Bottle", "CAddTable", "Cell",
           "ClassNLLCriterion", "Concat", "ConcatTable", "ConstInitMethod",
           "Container", "ConvLSTMPeephole", "ConvLSTMPeephole3D",
           "CrossEntropyCriterion", "Dropout", "Flatten", "GRU", "Graph",
           "Identity", "InitializationMethod", "Input", "Int8Linear",
           "JoinTable", "LSTM", "LSTMPeephole", "LayerNormalization",
           "Linear", "LogSoftMax", "LookupTable", "LookupTableSparse",
           "MapTable", "Module", "MsraFiller", "MultiRNNCell", "Node",
           "Ones", "ParallelTable", "QuantizedLinear",
           "QuantizedSpatialConvolution",
           "QuantizedSpatialDilatedConvolution", "Quantizer",
           "RandomNormal", "RandomUniform", "ReLU", "Recurrent",
           "RecurrentDecoder", "Reshape", "RnnCell", "SelectTable",
           "Sequential", "Sigmoid", "SoftMax", "SpatialAveragePooling",
           "SpatialBatchNormalization", "SpatialConvolution",
           "SpatialCrossMapLRN", "SpatialDilatedConvolution",
           "SpatialMaxPooling", "Tanh", "TimeDistributed",
           "TimeDistributedCriterion", "TreeGather", "TreeLSTM", "Xavier",
           "Zeros", "grad_scales", "quantize_model", "regularization_loss",
           "regularizers", "takes_generator"]
