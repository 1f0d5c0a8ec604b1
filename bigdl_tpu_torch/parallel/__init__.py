from bigdl_tpu_torch.parallel.sequence import (MultiHeadAttention,
                                               full_attention,
                                               paged_attention, paged_gather,
                                               paged_write,
                                               paged_write_index)

__all__ = ["MultiHeadAttention", "full_attention", "paged_attention",
           "paged_gather", "paged_write", "paged_write_index"]
