from bigdl_tpu_torch.nn.activation import (ELU, Abs, Exp, Identity, Log,
                                           LogSoftMax, Maxout, Negative,
                                           Power, PReLU, ReLU, ReLU6,
                                           Sigmoid, SoftMax, SoftPlus,
                                           SoftSign, Sqrt, Square, Tanh)
from bigdl_tpu_torch.nn.basic import (AddConstant, CAdd, CMul, Dropout,
                                      Flatten, Mean, MulConstant, Narrow,
                                      Reshape, Scale, SpatialZeroPadding,
                                      Squeeze, Sum, Tile, View)
from bigdl_tpu_torch.nn.containers import (Bottle, Concat, ConcatTable,
                                           Container, MapTable, ParallelTable,
                                           Sequential)
from bigdl_tpu_torch.nn.conv import (SpatialConvolution,
                                     SpatialDilatedConvolution,
                                     SpatialFullConvolution,
                                     TemporalConvolution,
                                     VolumetricConvolution,
                                     VolumetricFullConvolution)
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
from bigdl_tpu_torch.nn.locally_connected import (LocallyConnected1D,
                                                  LocallyConnected2D)
from bigdl_tpu_torch.nn.misc import BinaryThreshold, Highway, InferReshape
from bigdl_tpu_torch.nn.module import (Module, grad_scales,
                                       regularization_loss, regularizers,
                                       takes_generator)
from bigdl_tpu_torch.nn.normalization import (BatchNormalization,
                                              LayerNormalization,
                                              SpatialBatchNormalization,
                                              SpatialCrossMapLRN,
                                              SpatialWithinChannelLRN,
                                              VolumetricBatchNormalization)
from bigdl_tpu_torch.nn.pooling import (SpatialAveragePooling,
                                        SpatialMaxPooling, TemporalMaxPooling,
                                        VolumetricAveragePooling,
                                        VolumetricMaxPooling)
from bigdl_tpu_torch.nn.quantized import (
    Int8Linear, QuantizedLinear, QuantizedSpatialConvolution,
    QuantizedSpatialDilatedConvolution, Quantizer, quantize_model)
from bigdl_tpu_torch.nn.recurrent import (GRU, LSTM, BiRecurrent, Cell,
                                          ConvLSTMPeephole,
                                          ConvLSTMPeephole3D, LSTMPeephole,
                                          MultiRNNCell, Recurrent,
                                          RecurrentDecoder, RnnCell,
                                          TimeDistributed)
from bigdl_tpu_torch.nn.table_ops import (MM, CAddTable, CDivTable,
                                          CMaxTable, CMinTable, CMulTable,
                                          CSubTable, JoinTable, SelectTable)
from bigdl_tpu_torch.nn.tree_lstm import BinaryTreeLSTM, TreeGather, TreeLSTM

__all__ = ["Abs", "AddConstant", "BatchNormalization", "BiRecurrent",
           "BilinearFiller", "BinaryThreshold", "BinaryTreeLSTM", "Bottle",
           "CAdd", "CAddTable", "CDivTable", "CMaxTable", "CMinTable", "CMul",
           "CMulTable", "CSubTable", "Cell",
           "ClassNLLCriterion", "Concat", "ConcatTable", "ConstInitMethod",
           "Container", "ConvLSTMPeephole", "ConvLSTMPeephole3D",
           "CrossEntropyCriterion", "Dropout", "ELU", "Exp", "Flatten", "GRU",
           "Graph", "Highway", "Identity", "InferReshape", "InitializationMethod",
           "Input", "Int8Linear", "JoinTable", "LSTM", "LSTMPeephole",
           "LayerNormalization", "Linear", "LocallyConnected1D",
           "LocallyConnected2D", "Log", "LogSoftMax", "LookupTable",
           "LookupTableSparse", "MM", "MapTable", "Maxout", "Mean", "Module",
           "MsraFiller", "MulConstant", "MultiRNNCell", "Narrow", "Negative",
           "Node", "Ones", "PReLU",
           "ParallelTable", "Power", "QuantizedLinear",
           "QuantizedSpatialConvolution",
           "QuantizedSpatialDilatedConvolution", "Quantizer", "RandomNormal",
           "RandomUniform", "ReLU", "ReLU6", "Recurrent", "RecurrentDecoder",
           "Reshape", "RnnCell", "Scale", "SelectTable", "Sequential",
           "Sigmoid", "SoftMax", "SoftPlus", "SoftSign",
           "SpatialAveragePooling",
           "SpatialBatchNormalization", "SpatialConvolution",
           "SpatialCrossMapLRN", "SpatialDilatedConvolution",
           "SpatialFullConvolution", "SpatialMaxPooling",
           "SpatialWithinChannelLRN", "SpatialZeroPadding", "Sqrt", "Square",
           "Squeeze", "Sum", "Tanh", "TemporalConvolution",
           "TemporalMaxPooling", "Tile", "TimeDistributed", "TimeDistributedCriterion", "TreeGather",
           "TreeLSTM", "View", "VolumetricAveragePooling",
           "VolumetricBatchNormalization", "VolumetricConvolution",
           "VolumetricFullConvolution", "VolumetricMaxPooling", "Xavier", "Zeros", "grad_scales",
           "quantize_model", "regularization_loss", "regularizers",
           "takes_generator"]
