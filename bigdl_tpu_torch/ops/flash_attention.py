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

Three wrappers, one per kernel of ``ops/csrc/flash_attention.cu``:
:func:`flash_fwd`, :func:`flash_bwd_dq`, :func:`flash_bwd_dkv`. For CUDA
tensors each launches its kernel (or raises) and counts it in its
``launches``; for CPU tensors it runs its plain version
(:func:`flash_fwd_ref`, :func:`flash_bwd_dq_ref`, :func:`flash_bwd_dkv_ref`),
which takes the same inputs and recomputes ``p`` as the kernel does. The
kernels are built for ``head_dim`` 64 (GPT-2's), causal or not, in float32
and bfloat16; any ``S`` works.

Masked scores are ``NEG_INF`` (finite), so a causal or ragged row never
meets ``inf - inf``.
"""

from __future__ import annotations

import ctypes

import torch

from bigdl_tpu_torch.ops import NEG_INF, _build

# the head_dim the CUDA kernels are instantiated for: GPT-2's 64
HEAD_DIM = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _declare(lib):
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tail = [i32, i32, i32, f32, i32, i32, ptr]    # BH, S, D, scale, causal,
    lib.bigdl_flash_fwd.argtypes = [ptr] * 5 + tail           # dtype, stream
    lib.bigdl_flash_bwd_dq.argtypes = [ptr] * 8 + tail
    lib.bigdl_flash_bwd_dkv.argtypes = [ptr] * 9 + tail
    for fn in (lib.bigdl_flash_fwd, lib.bigdl_flash_bwd_dq,
               lib.bigdl_flash_bwd_dkv):
        fn.restype = ctypes.c_int


def _scale(q, sm_scale):
    return q.shape[-1] ** -0.5 if sm_scale is None else float(sm_scale)


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
def _check_cuda_args(fn, q, planes, rows):
    """Raise unless the kernel takes these tensors: every one on ``q``'s
    CUDA device, contiguous and 16-byte aligned; ``q`` (B, H, S, 64) of
    float32 or bfloat16 and each of ``planes`` of its shape and type; each
    of ``rows`` (B, H, S) float32."""
    if q.dim() != 4 or q.shape[-1] != HEAD_DIM:
        raise ValueError(f"{fn}: q must be (B, H, S, {HEAD_DIM}), got "
                         f"{tuple(q.shape)}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"{fn}: dtype {q.dtype} not in (float32, bfloat16)")
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


def _launch(fn_name, *args):
    lib = _build.load("flash_attention", _declare)
    err = getattr(lib, fn_name)(*args)
    if err != 0:
        raise RuntimeError(f"{fn_name} kernel launch failed: cudaError_t "
                           f"{err}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _tail(q, causal, sm_scale):
    b, h, s, d = q.shape
    return (b * h, s, d, float(sm_scale), int(bool(causal)), _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)


def flash_fwd(q, k, v, causal=False, sm_scale=None):
    """Forward kernel: ``(o, lse)`` for (B, H, S, D) inputs (see module
    docstring)."""
    sm_scale = _scale(q, sm_scale)
    if q.device.type == "cpu":
        return flash_fwd_ref(q, k, v, causal, sm_scale)
    _check_cuda_args("flash_fwd", q, {"k": k, "v": v}, {})
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
    _launch("bigdl_flash_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), lse.data_ptr(), *_tail(q, causal, sm_scale))
    flash_fwd.launches += 1
    return o, lse


def flash_bwd_dq(q, k, v, do, lse, delta, dlse=None, causal=False,
                 sm_scale=None):
    """dQ kernel (``dlse=None`` means zero)."""
    sm_scale = _scale(q, sm_scale)
    if q.device.type == "cpu":
        return flash_bwd_dq_ref(q, k, v, do, lse, delta, dlse, causal,
                                sm_scale)
    _check_cuda_args("flash_bwd_dq", q, {"k": k, "v": v, "do": do},
                     {"lse": lse, "delta": delta, "dlse": dlse})
    dq = torch.empty_like(q)
    _launch("bigdl_flash_bwd_dq", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), _ptr(dlse),
            dq.data_ptr(), *_tail(q, causal, sm_scale))
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, dlse=None, causal=False,
                  sm_scale=None):
    """dK/dV kernel (``dlse=None`` means zero): returns ``(dk, dv)``."""
    sm_scale = _scale(q, sm_scale)
    if q.device.type == "cpu":
        return flash_bwd_dkv_ref(q, k, v, do, lse, delta, dlse, causal,
                                 sm_scale)
    _check_cuda_args("flash_bwd_dkv", q, {"k": k, "v": v, "do": do},
                     {"lse": lse, "delta": delta, "dlse": dlse})
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("bigdl_flash_bwd_dkv", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), _ptr(dlse),
            dk.data_ptr(), dv.data_ptr(), *_tail(q, causal, sm_scale))
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_fwd.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


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
           "visible_pairs", "HEAD_DIM"]
