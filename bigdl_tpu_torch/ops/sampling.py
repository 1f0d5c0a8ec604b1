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
:func:`fused_sample_logits_ref` for CPU tensors. The kernel splits each row
across a cluster of CLUSTER CTAs (each its share of ``ceil(V / CLUSTER)``
logits, a split of V alone) and finds each cut by a radix select, 8 bits
of the order-preserving key a round (:func:`sample_plan` mirrors its
launch). A row of up to ``MAX_VOCAB`` logits (428,032: Llama-3's 128,256
among them) lives in the cluster's shared memory
(``fused_sample_logits.launches`` counts these launches); a longer one is
re-read and re-scaled from global memory on each pass
(``.long_row_launches``), the same arithmetic. Top-p weighs each entry by
``exp(l - max)`` in fixed point (``mass_bits`` fraction bits) and keeps
``l_i`` iff the weight above it is under ``ceil(Z * p)``, Z the total:
integer sums, so a call repeats bit for bit. It agrees with the
bisection's float32 sums except where a mass lies within rounding of p.
With ``paths=`` the kernel also reports each row's path: PATH_DRAW (no
cut), PATH_SMALL (top-k kept at most SMALL_SET entries: gathered to rank
0, which finished the cuts and drew alone; gathered early, after the
first round whose bucket and those above it hold at most EARLY_SET) or
PATH_RADIX (the cluster's top-p rounds).
"""

from __future__ import annotations

import ctypes

import torch

from bigdl_tpu_torch.ops import NEG_INF, _build

BISECT_ITERS = 60      # the plain version's halvings (the reference's)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# the kernel's launch (ops/csrc/sampling.cu): CTAs a row (one cluster),
# threads a CTA, the largest kept set gathered to rank 0 (EARLY_SET before
# the last top-k round), and the shared memory a CTA holds before its
# staged share (histograms, the gathered set, reductions)
CLUSTER = 8
THREADS = 1024
SMALL_SET = 512
EARLY_SET = 128
FIXED_SMEM = 18432
MAX_SMEM = 232448
# the longest row the cluster's shared memory holds; longer rows are
# re-read from global memory on each pass
MAX_VOCAB = CLUSTER * ((MAX_SMEM - FIXED_SMEM) // 4)
MASS_BITS = 40
PATH_DRAW, PATH_SMALL, PATH_RADIX = 0, 1, 2


def _declare(lib):
    fn = lib.bigdl_fused_sample
    fn.argtypes = ([ctypes.c_void_p] * 5
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int


def mass_bits(v):
    """Fraction bits of the fixed-point top-p weight at ``v`` logits a
    row: MASS_BITS, fewer where ``v * 2**bits`` would reach 2**63."""
    return min(MASS_BITS, 63 - int(v).bit_length())


def sample_plan(s, v):
    """Host-side plan of one kernel launch on (s, v) logits, as the C
    entry makes it: a cluster of CLUSTER CTAs of THREADS per row (grid
    ``s * CLUSTER``); CTA r's share of the row, ``[r * share, (r + 1) *
    share)`` cut at v, ``share = ceil(v / CLUSTER)`` (v alone decides it,
    never s); the variant, "shared memory" when ``v <= MAX_VOCAB`` (the
    share staged after FIXED_SMEM bytes) else "global" (re-read each
    pass); the dynamic shared memory; and ``mass_bits``."""
    share = -(-v // CLUSTER)
    in_smem = v <= MAX_VOCAB
    return {"cluster": CLUSTER, "threads": THREADS, "grid": s * CLUSTER,
            "share": share,
            "shares": [(min(v, r * share), min(v, (r + 1) * share))
                       for r in range(CLUSTER)],
            "variant": "shared memory" if in_smem else "global",
            "smem_bytes": FIXED_SMEM + (4 * share if in_smem else 0),
            "small_set": SMALL_SET, "early_set": EARLY_SET,
            "mass_bits": mass_bits(v)}


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


def _truncated_ref(logits, temperature, top_k, top_p):
    """The plain version's scaled, truncated logits (cut entries at
    NEG_INF) and the mask of the entries the draw reads: every entry with
    no cut, else those the cuts kept. Also, with top-k on, which rows the
    kernel takes on its small-set path: top-k kept at most SMALL_SET
    entries of a row with a real one (None with top-k off)."""
    v = logits.shape[-1]
    l = logits.float() / _row_temps(temperature, logits)[:, None].clamp_min(
        1e-6)
    kept = torch.ones_like(l, dtype=torch.bool)
    small = None
    if top_k is not None and 0 < top_k < v:
        kth = _cutoff_ref(l, torch.ones_like(l), float(top_k))
        kept = l >= kth
        small = ((kept.sum(dim=-1) <= SMALL_SET)
                 & (l > 0.5 * NEG_INF).any(dim=-1))
        l = torch.where(kept, l, torch.full_like(l, NEG_INF))
    if top_p is not None and top_p < 1.0:
        e = torch.exp(l - l.amax(dim=-1, keepdim=True))
        probs = e / e.sum(dim=-1, keepdim=True)
        cut = _cutoff_ref(l, probs, float(top_p))
        kept = kept & (l >= cut)
        l = torch.where(l < cut, torch.full_like(l, NEG_INF), l)
    return l, kept, small


def kept_ref(logits, temperature=1.0, top_k=None, top_p=None):
    """(S, V) bool: the entries whose noise the draw reads (the kept set;
    every entry with no cut), by the plain version."""
    return _truncated_ref(logits, temperature, top_k, top_p)[1]


def fused_sample_logits_ref(logits, gumbel, temperature=1.0, top_k=None,
                            top_p=None, paths=None):
    """Plain PyTorch version of the fused sampler (see module docstring).
    Returns (S,) int32 tokens; with ``paths`` (an (S,) int32 tensor) also
    fills in the path the kernel takes for each row."""
    l, _, small = _truncated_ref(logits, temperature, top_k, top_p)
    if paths is not None:
        if small is not None:
            paths.copy_(torch.where(small, PATH_SMALL, PATH_RADIX))
        else:
            cut = top_p is not None and top_p < 1.0
            paths.fill_(PATH_RADIX if cut else PATH_DRAW)
    # torch.argmax returns the first maximal index, the reference's rule
    return torch.argmax(l + gumbel.float(), dim=-1).to(torch.int32)


def fused_sample_logits(logits, gumbel, temperature=1.0, top_k=None,
                        top_p=None, paths=None):
    """Sampling over (S, V) ``logits`` with the caller's (S, V) ``gumbel``
    noise of the same dtype; ``temperature`` is a scalar or (S,)/(S, 1)
    per-row values. The CUDA kernel for CUDA tensors,
    :func:`fused_sample_logits_ref` for CPU tensors. Returns (S,) int32.
    ``paths``: None, or an (S,) int32 tensor on the logits' device that
    receives each row's path (PATH_*)."""
    if logits.dim() != 2 or gumbel.shape != logits.shape:
        raise ValueError(f"fused_sample_logits: logits {tuple(logits.shape)}"
                         f" and gumbel {tuple(gumbel.shape)} must be one "
                         f"(S, V) shape")
    if paths is not None and (paths.shape != logits.shape[:1]
                              or paths.dtype != torch.int32
                              or paths.device != logits.device
                              or not paths.is_contiguous()):
        raise ValueError("fused_sample_logits: paths must be a contiguous "
                         "(S,) int32 tensor on the logits' device")
    if not logits.is_cuda:
        return fused_sample_logits_ref(logits, gumbel, temperature, top_k,
                                       top_p, paths)
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
                   top_p, paths)


def _launch(logits, gumbel, temps, top_k, top_p, paths=None):
    """Launch the kernel on checked card tensors and count the launch: the
    row in the cluster's shared memory up to ``MAX_VOCAB`` logits
    (``.launches``), else re-read from global memory
    (``.long_row_launches``)."""
    s, v = logits.shape
    lib = _build.load("sampling", _declare)
    out = torch.empty(s, dtype=torch.int32, device=logits.device)
    err = lib.bigdl_fused_sample(
        logits.data_ptr(), gumbel.data_ptr(), temps.data_ptr(),
        out.data_ptr(), None if paths is None else paths.data_ptr(), s, v,
        0 if top_k is None else int(top_k),
        1.0 if top_p is None else float(top_p), mass_bits(v),
        _DTYPES[logits.dtype],
        torch.cuda.current_stream(logits.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused sampling kernel launch failed: "
                           f"cudaError_t {err}")
    if v > MAX_VOCAB:
        fused_sample_logits.long_row_launches += 1
    else:
        fused_sample_logits.launches += 1
    return out


# launches with the row in the cluster's shared memory (.launches) and
# re-read from global memory (.long_row_launches)
fused_sample_logits.launches = fused_sample_logits.long_row_launches = 0


def gumbel_noise(shape, generator, device, dtype=torch.float32):
    """Standard gumbel noise ``-log(-log(u))``, ``u`` uniform in [tiny, 1)
    from ``generator`` — the same construction as ``jax.random.gumbel``
    (different bits: torch's generator is not JAX's)."""
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return (-torch.log(-torch.log(u))).to(dtype)


def bytes_and_flops(logits, top_k=None, top_p=None, kept=None):
    """The least HBM bytes and float operations the function needs for
    one call on (S, V) ``logits``: the logits read once, the noise of the
    ``kept`` entries (the tokens that can win the draw; every entry when
    None), the temperatures read and the tokens written; per element the
    temperature divide, with top-p its subtract and exp, and per kept
    entry the draw's add and compare. A selection takes a constant number
    of passes, so the cuts add no term that grows with an algorithm's
    steps: the bisection's 2 x 60 operations an element and cut that this
    count once held were the reference kernel's way to the cut, not the
    function's work."""
    s, v = logits.shape
    n = logits.numel()
    kept = n if kept is None else int(kept)
    elt = logits.element_size()
    nbytes = n * elt + kept * elt + 8 * s
    top_p_on = top_p is not None and top_p < 1.0
    return nbytes, n * (1 + 2 * top_p_on) + 2 * kept


__all__ = ["fused_sample_logits", "fused_sample_logits_ref", "kept_ref",
           "gumbel_noise", "bytes_and_flops", "sample_plan", "mass_bits",
           "BISECT_ITERS", "MAX_VOCAB", "CLUSTER", "SMALL_SET", "PATH_DRAW",
           "PATH_SMALL", "PATH_RADIX"]
