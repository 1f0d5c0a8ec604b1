"""Hand-written Hopper kernels and their plain PyTorch versions.

- ``paged_attention``: chunk/decode attention straight against the paged
  K/V pool (replaces the Pallas ``_decode_kernel`` of
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
"""

# finite stand-in for -inf (the reference's ``ops/pallas_util.py``
# NEG_INF): masked scores and truncated logits use it, so the online
# softmax's exp(x - m) arithmetic never meets inf - inf
NEG_INF = -1e30
