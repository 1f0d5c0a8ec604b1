"""Fused sampling: temperature / top-k / top-p / categorical draw in one
pass over (slots, vocab) logits (the port of ``bigdl_tpu/ops/
sampling.py``).

Semantics are the reference kernel's, exactly:

- ``l = logits / max(temperature, 1e-6)`` (temperatures are first rounded
  to the logits' dtype, as the reference broadcasts them in it);
- top-k (``0 < top_k < V``) and top-p (``top_p < 1``) are per-row cutoff
  VALUES, each found by 60 halvings of ``[min over unmasked l - 1, max
  l]`` on a monotone measure of ``l > mid`` (the count for top-k, the
  softmax mass for top-p) and snapped to the smallest logit above the
  final lower end; logits below a cutoff become ``NEG_INF``;
- the draw is ``argmax(l + gumbel)``, the first index on ties. The gumbel
  noise is an input: the caller draws it (the engine with its own
  ``torch.Generator``), so tests can inject the reference's noise.

:func:`fused_sample_logits` launches the CUDA kernel ``ops/csrc/
sampling.cu`` for CUDA tensors (or raises) and runs
:func:`fused_sample_logits_ref` for CPU tensors. Any vocabulary: a row of
up to ``MAX_VOCAB`` logits lives in the kernel's shared memory
(``fused_sample_logits.launches`` counts these launches); a longer row
(Llama-3's 128,256) lives in a float32 (S, V) scratch the wrapper
allocates, which stays in the card's 50 MB L2, so each of the ~120 passes
over it is bound by L2 reads (``.long_row_launches``).
"""

from __future__ import annotations

import ctypes

import torch

from bigdl_tpu_torch.ops import NEG_INF, _build

BISECT_ITERS = 60
# the longest row the kernel keeps in dynamic shared memory: 227 KB a block
# on Hopper, less its static reduction slots; longer rows go to a scratch
MAX_VOCAB = (232448 - 1024) // 4
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _declare(lib):
    fn = lib.bigdl_fused_sample
    fn.argtypes = ([ctypes.c_void_p] * 5
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int


def _row_temps(temperature, logits):
    """Per-row float32 temperatures (S,), rounded through the logits'
    dtype like the reference's broadcast."""
    s = logits.shape[0]
    t = torch.as_tensor(temperature, dtype=torch.float32,
                        device=logits.device).reshape(-1)
    t = t.expand(s) if t.numel() == 1 else t
    if t.numel() != s:
        raise ValueError(f"temperature has {t.numel()} entries for {s} rows")
    return t.to(logits.dtype).float().contiguous()


def _cutoff_ref(l, weights, level):
    """Per-row threshold c (S, 1) such that keeping ``l >= c`` keeps the
    tokens with ``sum(weights[l > l_i]) < level`` (see module docstring).
    Bisection invariant: measure(> lo) >= level, measure(> hi) < level."""
    level = torch.tensor(level, dtype=torch.float32)
    real = l > 0.5 * NEG_INF
    big = torch.full_like(l, -NEG_INF)
    lo = torch.where(real, l, big).amin(dim=-1, keepdim=True) - 1.0
    hi = l.amax(dim=-1, keepdim=True)
    zero = torch.zeros_like(weights)
    for _ in range(BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        mass = torch.where(l > mid, weights, zero).sum(dim=-1, keepdim=True)
        pred = mass >= level
        lo = torch.where(pred, mid, lo)
        hi = torch.where(pred, hi, mid)
    return torch.where(l > lo, l, big).amin(dim=-1, keepdim=True)


def fused_sample_logits_ref(logits, gumbel, temperature=1.0, top_k=None,
                            top_p=None):
    """Plain PyTorch version of the fused sampler (see module docstring).
    Returns (S,) int32 tokens."""
    v = logits.shape[-1]
    l = logits.float() / _row_temps(temperature, logits)[:, None].clamp_min(
        1e-6)
    if top_k is not None and 0 < top_k < v:
        kth = _cutoff_ref(l, torch.ones_like(l), float(top_k))
        l = torch.where(l < kth, torch.full_like(l, NEG_INF), l)
    if top_p is not None and top_p < 1.0:
        e = torch.exp(l - l.amax(dim=-1, keepdim=True))
        probs = e / e.sum(dim=-1, keepdim=True)
        cut = _cutoff_ref(l, probs, float(top_p))
        l = torch.where(l < cut, torch.full_like(l, NEG_INF), l)
    # torch.argmax returns the first maximal index, the reference's rule
    return torch.argmax(l + gumbel.float(), dim=-1).to(torch.int32)


def fused_sample_logits(logits, gumbel, temperature=1.0, top_k=None,
                        top_p=None):
    """One-pass sampling over (S, V) ``logits`` with the caller's (S, V)
    ``gumbel`` noise of the same dtype; ``temperature`` is a scalar or
    (S,)/(S, 1) per-row values. The CUDA kernel for CUDA tensors,
    :func:`fused_sample_logits_ref` for CPU tensors. Returns (S,) int32."""
    if logits.dim() != 2 or gumbel.shape != logits.shape:
        raise ValueError(f"fused_sample_logits: logits {tuple(logits.shape)}"
                         f" and gumbel {tuple(gumbel.shape)} must be one "
                         f"(S, V) shape")
    if not logits.is_cuda:
        return fused_sample_logits_ref(logits, gumbel, temperature, top_k,
                                       top_p)
    if gumbel.device != logits.device:
        raise ValueError("fused_sample_logits: gumbel is on "
                         f"{gumbel.device}, logits on {logits.device}")
    if logits.dtype not in _DTYPES or gumbel.dtype != logits.dtype:
        raise TypeError(f"fused_sample_logits: logits/gumbel dtypes "
                        f"{logits.dtype}/{gumbel.dtype}; want one of "
                        f"float32, bfloat16")
    if not (logits.is_contiguous() and gumbel.is_contiguous()):
        raise ValueError("fused_sample_logits: logits and gumbel must be "
                         "contiguous")
    return _launch(logits, gumbel, _row_temps(temperature, logits), top_k,
                   top_p)


def _launch(logits, gumbel, temps, top_k, top_p):
    """Launch the kernel on checked card tensors and count the launch: the
    row in shared memory up to ``MAX_VOCAB`` logits, else in a float32
    (S, V) scratch allocated here."""
    s, v = logits.shape
    lib = _build.load("sampling", _declare)
    out = torch.empty(s, dtype=torch.int32, device=logits.device)
    long_row = v > MAX_VOCAB
    scratch = (torch.empty((s, v), dtype=torch.float32, device=logits.device)
               if long_row else None)
    err = lib.bigdl_fused_sample(
        logits.data_ptr(), gumbel.data_ptr(), temps.data_ptr(),
        out.data_ptr(), None if scratch is None else scratch.data_ptr(), s,
        v, 0 if top_k is None else int(top_k),
        1.0 if top_p is None else float(top_p), _DTYPES[logits.dtype],
        torch.cuda.current_stream(logits.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused sampling kernel launch failed: "
                           f"cudaError_t {err}")
    if long_row:
        fused_sample_logits.long_row_launches += 1
    else:
        fused_sample_logits.launches += 1
    return out


# launches with the row in shared memory (.launches) and in the scratch
# (.long_row_launches)
fused_sample_logits.launches = fused_sample_logits.long_row_launches = 0


def gumbel_noise(shape, generator, device, dtype=torch.float32):
    """Standard gumbel noise ``-log(-log(u))``, ``u`` uniform in [tiny, 1)
    from ``generator`` — the same construction as ``jax.random.gumbel``
    (different bits: torch's generator is not JAX's)."""
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return (-torch.log(-torch.log(u))).to(dtype)


def bytes_and_flops(logits, top_k=None, top_p=None):
    """The least HBM bytes (logits and noise read once, temperatures read
    and tokens written once) and the float operations the function needs
    for one call: per element, the temperature divide and the final add
    and compare, plus for each active cutoff two per bisection step
    (compare, accumulate) and its bracket, snap and mask passes; top-p
    adds one softmax (max and sum passes, subtract, exp, divide), which
    the function needs once, whatever the kernel recomputes."""
    s, v = logits.shape
    nbytes = 2 * logits.numel() * logits.element_size() + 8 * s
    per_elem = 3
    if top_k is not None and 0 < top_k < v:
        per_elem += 2 * BISECT_ITERS + 4
    if top_p is not None and top_p < 1.0:
        per_elem += 2 * BISECT_ITERS + 4 + 5
    return nbytes, per_elem * logits.numel()


__all__ = ["fused_sample_logits", "fused_sample_logits_ref", "gumbel_noise",
           "bytes_and_flops", "BISECT_ITERS", "MAX_VOCAB"]
