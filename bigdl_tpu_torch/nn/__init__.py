from bigdl_tpu_torch.nn.criterion import (ClassNLLCriterion,
                                          CrossEntropyCriterion)
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.normalization import LayerNormalization

__all__ = ["ClassNLLCriterion", "CrossEntropyCriterion", "Linear",
           "LayerNormalization"]
