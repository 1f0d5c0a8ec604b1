from bigdl_tpu_torch.nn.criterion import (ClassNLLCriterion,
                                          CrossEntropyCriterion)
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.normalization import LayerNormalization
from bigdl_tpu_torch.nn.quantized import Int8Linear, quantize_model

__all__ = ["ClassNLLCriterion", "CrossEntropyCriterion", "Linear",
           "LayerNormalization", "Int8Linear", "quantize_model"]
