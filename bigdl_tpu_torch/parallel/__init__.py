from bigdl_tpu_torch.parallel.allreduce import (AllReduceParameter,
                                                allreduce_bandwidth,
                                                make_distributed_eval_step,
                                                make_distributed_train_step)
from bigdl_tpu_torch.parallel.distri_optimizer import DistriOptimizer
from bigdl_tpu_torch.parallel.pipeline import (make_pipeline_train_step,
                                               pipeline_apply)
from bigdl_tpu_torch.parallel.sequence import (MultiHeadAttention,
                                               full_attention,
                                               paged_attention, paged_gather,
                                               paged_write,
                                               paged_write_index)

__all__ = ["AllReduceParameter", "DistriOptimizer", "MultiHeadAttention",
           "allreduce_bandwidth",
           "full_attention", "make_distributed_eval_step",
           "make_distributed_train_step", "make_pipeline_train_step",
           "paged_attention", "pipeline_apply",
           "paged_gather", "paged_write", "paged_write_index"]
