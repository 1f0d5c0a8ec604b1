from bigdl_tpu_torch.parallel.sequence import (MultiHeadAttention,
                                               paged_attention, paged_gather,
                                               paged_write,
                                               paged_write_index)

__all__ = ["MultiHeadAttention", "paged_attention", "paged_gather",
           "paged_write", "paged_write_index"]
