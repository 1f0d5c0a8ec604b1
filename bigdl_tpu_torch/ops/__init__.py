"""Hand-written Hopper kernels and their plain PyTorch versions.

- ``paged_attention``: chunk/decode attention straight against the paged
  K/V pool, float or int8 with scale planes (replaces the Pallas
  ``_decode_kernel`` and ``_decode_kernel_quant`` of
  ``bigdl_tpu/ops/paged_attention.py``);
- ``flash_attention``: the FlashAttention-2 forward and its dQ and dK/dV
  backward kernels, one ``torch.autograd.Function`` (replaces the Pallas
  ``_fwd_kernel``, ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` of
  ``bigdl_tpu/ops/flash_attention.py``);
- ``sampling``: one-pass temperature / top-k / top-p / gumbel-argmax
  sampling (replaces the Pallas ``_sample_kernel`` of
  ``bigdl_tpu/ops/sampling.py``).

Each wrapper launches its CUDA kernel for CUDA tensors (or raises) and
runs the plain version only for CPU tensors; ``launches`` on the wrapper
counts kernel launches.

Beside the kernels, the TF-style operation layers and control flow of the
reference's ``bigdl_tpu/ops`` (``tf_ops.py``, ``control_ops.py``): the
ops the TF graph loader builds, the feature-column ops, ``Cond``,
``WhileLoop`` and ``Select``. The reference's ``ops.flash_attention``
function is the port's ``ops.flash_attention.flash_attention``: the name
here is the kernel's module.
"""

# finite stand-in for -inf (the reference's ``ops/pallas_util.py``
# NEG_INF): masked scores and truncated logits use it, so the online
# softmax's exp(x - m) arithmetic never meets inf - inf
NEG_INF = -1e30

from bigdl_tpu_torch.ops.control_ops import Cond, Select, WhileLoop  # noqa: E402,F401
from bigdl_tpu_torch.ops.tf_ops import (  # noqa: E402,F401
    All, Any, ArgMax, ArgMin, BucketizedCol, Cast, CategoricalColHashBucket,
    CategoricalColVocaList, Ceil, CrossCol, Equal, Erf, Exp, ExpandDims,
    Floor, Gather, Greater, GreaterEqual, IndicatorCol, InTopK,
    InvertPermutation, Less, LessEqual, Log1p, LogicalAnd, LogicalNot,
    LogicalOr, MkString, NotEqual, OneHot, Operation, Pow, Prod, Rank, Round,
    SegmentSum, Sign, Slice, StridedSlice, Tile, TopK)
