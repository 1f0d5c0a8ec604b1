"""Flash attention: the FlashAttention-2 forward and backward (the port of
``bigdl_tpu/ops/flash_attention.py``).

Public functions take the reference's ``(B, H, S, D)`` layout:

- :func:`flash_attention` returns ``o``;
- :func:`flash_attention_with_lse` returns ``(o, lse)``, ``lse`` of
  ``(B, H, S)`` float32 (the reference's ``(bh, 8, s)`` is TPU sublane
  padding and is not copied). Its backward folds the ``lse`` cotangent
  into ``ds = p * (dp - delta + dlse) * scale``.

Both go through one ``torch.autograd.Function``: the forward saves ``q,
k, v, o, lse``; the backward computes ``delta = rowsum(dO * O)`` in
float32 (as the reference does outside its kernels) and runs the dQ and
the dK/dV kernels, which recompute ``p = exp(s - lse)`` instead of
storing the score matrix.

Three wrappers, one per TPU kernel, over ``ops/csrc/flash_attention.cu``:
:func:`flash_fwd`, :func:`flash_bwd_dq`, :func:`flash_bwd_dkv`. For CPU
tensors each runs its plain version (:func:`flash_fwd_ref`,
:func:`flash_bwd_dq_ref`, :func:`flash_bwd_dkv_ref`), which takes the same
inputs and recomputes ``p`` as the kernels do. For CUDA tensors each
launches the kernel its shape and type select, or raises:

- bfloat16 runs on the tensor cores (wgmma), counted in ``.tc_launches``;
  :func:`tc_plan` mirrors the tiles and shared memory the C entries pick;
- float32 runs on the CUDA cores (float32 FMAs), counted in ``.launches``.

Every kernel is instantiated at the widths ``HEAD_DIMS`` (64, 128). Any
``head_dim`` up to 128 runs on the next width up (:func:`kernel_head_dim`):
the wrapper zero-pads the last axis of q, k, v (and dO) to that width,
launches, and slices the outputs back. Padding is exact: zero columns add
exact zeros to every q.k, dO.v and dS.k product, a zero column of v gives
a zero output column (sliced away), and lse and delta are untouched; the
softmax scale stays ``D ** -0.5`` of the true D. A ``head_dim`` above 128
raises, naming the ROADMAP queue C item that will add it.

:func:`path` is the one place that decides which of these a call takes.

Causal or not; any ``S`` works.

Masked scores are ``NEG_INF`` (finite), so a causal or ragged row never
meets ``inf - inf``.
"""

from __future__ import annotations

import ctypes

import torch

from bigdl_tpu_torch.ops import NEG_INF, _build

# the head_dims every kernel is instantiated for, on both paths; a smaller
# head_dim runs zero-padded on the next of them
HEAD_DIMS = (64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# the tensor-core kernels' tiling (ops/csrc/flash_attention.cu): threads a
# CTA (two warpgroups), ring stages, and a CTA's shared memory limit
TC_THREADS = 256
TC_STAGES = 2
TC_MAX_SMEM = 232448


def _declare(lib):
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    head = [i32, i32, i32, f32, i32]       # BH, S, D, scale, causal
    tail = head + [i32, ptr]               # + dtype, stream
    entries = {"bigdl_flash_fwd": [ptr] * 5 + tail,
               "bigdl_flash_bwd_dq": [ptr] * 8 + tail,
               "bigdl_flash_bwd_dkv": [ptr] * 9 + tail,
               "bigdl_flash_fwd_tc": [ptr] * 5 + head + [ptr],
               "bigdl_flash_bwd_dq_tc": [ptr] * 8 + head + [ptr],
               "bigdl_flash_bwd_dkv_tc": [ptr] * 9 + head + [ptr]}
    for name, argtypes in entries.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int


def _scale(q, sm_scale):
    return q.shape[-1] ** -0.5 if sm_scale is None else float(sm_scale)


def kernel_head_dim(head_dim):
    """The width of the kernel that runs a ``head_dim``: the smallest of
    HEAD_DIMS at least as wide, or None above 128."""
    return next((w for w in HEAD_DIMS if 0 < head_dim <= w), None)


# ------------------------------------------------------ plain versions --
def _scores(q, k, causal, sm_scale):
    """float32 ``q . k^T * scale``, ``NEG_INF`` above the diagonal when
    causal: (..., S, S)."""
    s = torch.einsum("...qd,...kd->...qk", q.float(), k.float()) * sm_scale
    if causal:
        n = q.shape[-2]
        seen = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~seen, NEG_INF)
    return s


def _as_operand(x, dtype):
    """float32 ``x`` rounded to ``dtype`` as a product's operand, the
    kernels' (and the reference's) bfloat16 rounding of ``p`` and ``ds``."""
    return x if dtype == torch.float32 else x.to(dtype).float()


def flash_fwd_ref(q, k, v, causal=False, sm_scale=None):
    """Plain forward: ``(o, lse)`` for (B, H, S, D) inputs, in float32 with
    ``o`` cast to ``q.dtype``; ``p = exp(s - m)`` enters the product with
    ``v`` rounded to the input type, as in the kernel."""
    sm_scale = _scale(q, sm_scale)
    s = _scores(q, k, causal, sm_scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = (_as_operand(p, q.dtype) @ v.float()) / l
    return o.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def _p_and_t(q, k, v, do, lse, delta, dlse, causal, sm_scale):
    """``p = exp(s - lse)`` and ``dp - delta + dlse`` (float32)."""
    p = torch.exp(_scores(q, k, causal, sm_scale) - lse[..., None])
    t = do.float() @ v.float().transpose(-1, -2) - delta[..., None]
    if dlse is not None:
        t = t + dlse[..., None]
    return p, t


def flash_bwd_dq_ref(q, k, v, do, lse, delta, dlse=None, causal=False,
                     sm_scale=None):
    """Plain dQ: ``(p * (dp - delta + dlse) * scale) . k``."""
    sm_scale = _scale(q, sm_scale)
    p, t = _p_and_t(q, k, v, do, lse, delta, dlse, causal, sm_scale)
    ds = _as_operand(p * t * sm_scale, q.dtype)
    return (ds @ k.float()).to(q.dtype)


def flash_bwd_dkv_ref(q, k, v, do, lse, delta, dlse=None, causal=False,
                      sm_scale=None):
    """Plain dK and dV: ``(ds^T . q, p^T . dO)``."""
    sm_scale = _scale(q, sm_scale)
    p, t = _p_and_t(q, k, v, do, lse, delta, dlse, causal, sm_scale)
    dv = _as_operand(p, q.dtype).transpose(-1, -2) @ do.float()
    ds = _as_operand(p * t * sm_scale, q.dtype)
    dk = ds.transpose(-1, -2) @ q.float()
    return dk.to(k.dtype), dv.to(v.dtype)


# ----------------------------------------------------------- wrappers --
def _ceil_div(a, b):
    return -(-a // b)


def tc_plan(kernel, bh, s, d):
    """Host-side plan of a tensor-core launch of ``kernel`` ("fwd", "dq"
    or "dkv") on (bh, s, d) inputs, as the C entry makes it for itself:

    - fwd: a CTA per (b*h, 128 query rows), two warpgroups of 64 rows;
      key tiles of 128 at d 64 and 64 at d 128 through a TC_STAGES ring;
      shared memory = 1 KiB of alignment slack, the Q tile, and TC_STAGES
      (K, V) tile pairs;
    - dq: the forward's CTAs, key tiles and ring; shared memory = 1 KiB,
      the resident Q and dO tiles, and TC_STAGES (K, V) tile pairs;
    - dkv: a CTA per (b*h, 128 keys), two warpgroups of 64 keys; query
      tiles of 64 through the ring; shared memory = 1 KiB, the K and V
      tiles, TC_STAGES (Q, dO) tile pairs and TC_STAGES x 3 float32 rows
      (lse, delta, dlse) of 64.

    A tile of r rows holds r x w bfloat16 values, w the launched width
    ``head_dim`` (:func:`kernel_head_dim` of ``d``)."""
    w = kernel_head_dim(d)
    if w is None:
        raise ValueError(f"tc_plan: head_dim {d} above {HEAD_DIMS[-1]}")
    d = w
    if kernel in ("fwd", "dq"):
        tile_q, tile_k = 128, (128 if d == 64 else 64)
        resident = 1 if kernel == "fwd" else 2          # Q; Q and dO
        smem = (1024 + resident * tile_q * d * 2
                + TC_STAGES * 2 * tile_k * d * 2)
        grid = (bh, _ceil_div(s, tile_q))
    elif kernel == "dkv":
        tile_q, tile_k = 64, 128
        smem = (1024 + 2 * tile_k * d * 2
                + TC_STAGES * (2 * tile_q * d * 2 + 3 * tile_q * 4))
        grid = (bh, _ceil_div(s, tile_k))
    else:
        raise ValueError(f"tc_plan: no tensor-core kernel {kernel!r}")
    return {"tile_q": tile_q, "tile_k": tile_k, "grid": grid,
            "threads": TC_THREADS, "stages": TC_STAGES, "smem_bytes": smem,
            "head_dim": w}


def path(fn, dtype, head_dim):
    """The kernel wrapper ``fn`` (by name: "flash_fwd", "flash_bwd_dq" or
    "flash_bwd_dkv") launches on the card for (B, H, S, ``head_dim``)
    inputs of ``dtype``: "tensor_cores" for bfloat16 and "cuda_cores" for
    float32, at the width :func:`kernel_head_dim` names (``head_dim`` up
    to 128); None where no kernel takes them yet."""
    if fn not in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv") \
            or kernel_head_dim(head_dim) is None:
        return None
    return {torch.bfloat16: "tensor_cores",
            torch.float32: "cuda_cores"}.get(dtype)


def _check_head_dim(fn, q):
    """Raise unless ``q`` is (B, H, S, D) with a :func:`path` for wrapper
    ``fn`` and ``q``'s type."""
    if q.dim() != 4 or path(fn, q.dtype, q.shape[-1]) is None:
        raise ValueError(
            f"{fn}: q must be (B, H, S, D) with D <= {HEAD_DIMS[-1]}, got "
            f"{tuple(q.shape)}; larger head_dims wait for ROADMAP queue C, "
            f"'flash and paged head dims above 128'")


def _check_cuda_args(fn, q, planes, rows):
    """Raise unless the kernel takes these tensors: ``q`` of float32 or
    bfloat16 and as :func:`_check_head_dim` wants it; every tensor on
    ``q``'s CUDA device, contiguous and 16-byte aligned; each of
    ``planes`` of ``q``'s shape and type; each of ``rows`` (B, H, S)
    float32."""
    if q.dtype not in _DTYPES:
        raise TypeError(f"{fn}: dtype {q.dtype} not in (float32, bfloat16)")
    _check_head_dim(fn, q)
    if not q.is_cuda:
        raise ValueError(f"{fn}: q is on {q.device}; the kernel needs a "
                         f"CUDA tensor")
    b, h, s, _ = q.shape
    for name, t, shape, dtype in (
            [("q", q, q.shape, q.dtype)]
            + [(n, t, q.shape, q.dtype) for n, t in planes.items()]
            + [(n, t, (b, h, s), torch.float32) for n, t in rows.items()
               if t is not None]):
        if t.device != q.device:
            raise ValueError(f"{fn}: {name} is on {t.device}, q on "
                             f"{q.device}")
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise ValueError(f"{fn}: {name} must be {tuple(shape)} {dtype}, "
                             f"got {tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} must be contiguous and 16-byte "
                             f"aligned")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _padded(width, *tensors):
    """``tensors`` (None passes through) zero-padded on the last axis to
    ``width``; a tensor already that wide is returned as it is."""
    return [t if t is None or t.shape[-1] == width
            else torch.nn.functional.pad(t, (0, width - t.shape[-1]))
            for t in tensors]


def _launch(fn, q, causal, sm_scale, *tensors):
    """Launch wrapper ``fn``'s kernel on ``tensors`` (its C entry's pointer
    arguments, None for a null pointer; q and the planes already padded to
    the kernel's width): the entry :func:`path` names for ``q``; then count
    the launch on ``fn``."""
    b, h, s, d = q.shape
    tc = path(fn.__name__, q.dtype, d) == "tensor_cores"
    entry = f"bigdl_{fn.__name__}" + ("_tc" if tc else "")
    lib = _build.load("flash_attention", _declare)
    dtype = () if tc else (_DTYPES[q.dtype],)
    err = getattr(lib, entry)(
        *map(_ptr, tensors), b * h, s, d, float(sm_scale),
        int(bool(causal)), *dtype,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: cudaError_t "
                           f"{err}")
    if tc:
        fn.tc_launches += 1
    else:
        fn.launches += 1


# The card branches: checked on the caller's tensors, run at the kernel's
# width (``sm_scale`` already taken from the true head_dim by the
# wrappers), outputs sliced back to the true head_dim.
def _fwd_on_card(q, k, v, causal, sm_scale):
    _check_cuda_args("flash_fwd", q, {"k": k, "v": v}, {})
    d = q.shape[-1]
    q, k, v = _padded(kernel_head_dim(d), q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
    _launch(flash_fwd, q, causal, sm_scale, q, k, v, o, lse)
    return o[..., :d].contiguous(), lse


def _dq_on_card(q, k, v, do, lse, delta, dlse, causal, sm_scale):
    _check_cuda_args("flash_bwd_dq", q, {"k": k, "v": v, "do": do},
                     {"lse": lse, "delta": delta, "dlse": dlse})
    d = q.shape[-1]
    q, k, v, do = _padded(kernel_head_dim(d), q, k, v, do)
    dq = torch.empty_like(q)
    _launch(flash_bwd_dq, q, causal, sm_scale, q, k, v, do, lse, delta,
            dlse, dq)
    return dq[..., :d].contiguous()


def _dkv_on_card(q, k, v, do, lse, delta, dlse, causal, sm_scale):
    _check_cuda_args("flash_bwd_dkv", q, {"k": k, "v": v, "do": do},
                     {"lse": lse, "delta": delta, "dlse": dlse})
    d = q.shape[-1]
    q, k, v, do = _padded(kernel_head_dim(d), q, k, v, do)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch(flash_bwd_dkv, q, causal, sm_scale, q, k, v, do, lse, delta,
            dlse, dk, dv)
    return dk[..., :d].contiguous(), dv[..., :d].contiguous()


def flash_fwd(q, k, v, causal=False, sm_scale=None):
    """Forward kernel: ``(o, lse)`` for (B, H, S, D) inputs (see module
    docstring)."""
    sm_scale = _scale(q, sm_scale)
    if q.device.type == "cpu":
        return flash_fwd_ref(q, k, v, causal, sm_scale)
    return _fwd_on_card(q, k, v, causal, sm_scale)


def flash_bwd_dq(q, k, v, do, lse, delta, dlse=None, causal=False,
                 sm_scale=None):
    """dQ kernel (``dlse=None`` means zero)."""
    sm_scale = _scale(q, sm_scale)
    if q.device.type == "cpu":
        return flash_bwd_dq_ref(q, k, v, do, lse, delta, dlse, causal,
                                sm_scale)
    return _dq_on_card(q, k, v, do, lse, delta, dlse, causal, sm_scale)


def flash_bwd_dkv(q, k, v, do, lse, delta, dlse=None, causal=False,
                  sm_scale=None):
    """dK/dV kernel (``dlse=None`` means zero): returns ``(dk, dv)``."""
    sm_scale = _scale(q, sm_scale)
    if q.device.type == "cpu":
        return flash_bwd_dkv_ref(q, k, v, do, lse, delta, dlse, causal,
                                 sm_scale)
    return _dkv_on_card(q, k, v, do, lse, delta, dlse, causal, sm_scale)


# launches of each wrapper's CUDA-core kernel (.launches) and tensor-core
# kernel (.tc_launches)
flash_fwd.launches = flash_fwd.tc_launches = 0
flash_bwd_dq.launches = flash_bwd_dq.tc_launches = 0
flash_bwd_dkv.launches = flash_bwd_dkv.tc_launches = 0


class _FlashAttention(torch.autograd.Function):
    """``(o, lse)`` with the flash backward (see module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        o, lse = flash_fwd(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        # an unused output's gradient arrives as None, not zeros: plain
        # flash_attention's lse costs the backward nothing
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        do = torch.zeros_like(o) if do is None else do.contiguous()
        if dlse is not None:
            dlse = dlse.float().contiguous()
        delta = (do.float() * o.float()).sum(dim=-1)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, dlse, ctx.causal,
                          ctx.sm_scale)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, dlse, ctx.causal,
                               ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention_with_lse(q, k, v, causal=False, sm_scale=None):
    """Flash attention over (B, H, S, D): ``(o, lse)``, both
    differentiable; ``sm_scale`` defaults to ``D ** -0.5``."""
    if q.dim() != 4:
        raise ValueError("flash_attention expects (batch, heads, seq, dim)")
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), bool(causal),
                                 _scale(q, sm_scale))


def flash_attention(q, k, v, causal=False, sm_scale=None):
    """Flash attention over (B, H, S, D): the output ``o``."""
    return flash_attention_with_lse(q, k, v, causal, sm_scale)[0]


def visible_pairs(b, h, s, causal):
    """(query, key) pairs the function computes: the lower triangle with
    its diagonal when causal."""
    return b * h * (s * (s + 1) // 2 if causal else s * s)


def bytes_and_flops(kernel, q, causal, dlse=False):
    """The least HBM bytes and float operations one call of ``kernel``
    ("fwd", "dq" or "dkv") needs on (B, H, S, D) inputs shaped like ``q``:
    each input read once and each output written once; 4*D operations per
    visible pair (forward: the S and P.V products; dQ: dP and dS.K; dK/dV:
    P^T.dO and dS^T.Q; the recomputation of S, and of dP in both backward
    kernels, is the flash design's choice and is not counted). ``dlse``:
    the lse cotangent is an input."""
    b, h, s, d = q.shape
    plane = b * h * s * d * q.element_size()
    row = b * h * s * 4
    if kernel == "fwd":
        nbytes = 3 * plane + plane + row                # q k v ; o lse
    else:
        reads = 4 * plane + (3 if dlse else 2) * row    # q k v dO ; lse delta
        nbytes = reads + (plane if kernel == "dq" else 2 * plane)
    return nbytes, 4 * d * visible_pairs(b, h, s, causal)


__all__ = ["flash_attention", "flash_attention_with_lse", "flash_fwd",
           "flash_bwd_dq", "flash_bwd_dkv", "flash_fwd_ref",
           "flash_bwd_dq_ref", "flash_bwd_dkv_ref", "bytes_and_flops",
           "visible_pairs", "path", "tc_plan", "kernel_head_dim",
           "HEAD_DIMS", "TC_MAX_SMEM"]
