"""bigdl_tpu_torch: the PyTorch/CUDA port of ``bigdl_tpu``, for one NVIDIA
H100.

The JAX package ``bigdl_tpu`` stays the reference; this package mirrors its
module layout (``ops/``, ``nn/``, ``parallel/``, ``models/``, ``serving/``,
``utils/``) so each counterpart is easy to find. It imports ``torch`` and
never ``jax`` or ``bigdl_tpu``. Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.

Every TPU (Pallas) kernel on a ported path is a hand-written CUDA C++
kernel for ``sm_90a`` under ``ops/csrc/``, built at first use by
``ops/_build.py``. On CPU tensors each kernel wrapper runs its plain
PyTorch version instead, which is how the CPU tests reach the same math.

Numerics: the JAX reference runs GPT-2 in float32 at full precision, so
importing this package turns TF32 off for both cuBLAS matmuls and cuDNN
convolutions (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32``). TF32 keeps about three decimal
digits, which would break temperature-0 token parity with the reference.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = []
