"""Int8 weights for serving (the port of ``bigdl_tpu/nn/quantized.py``:
``quantize_array``, ``_dynamic_quant``, ``qmatmul`` and
``quantize_params``).

- :func:`quantize_array`: symmetric int8 quantisation, ``scale =
  max(amax, 1e-8) / 127``, round half to even, clip to +-127;
- :func:`qmatmul`: ``x @ W`` for an int8 weight: the activation is
  quantised against ONE amax over the whole tensor (every row of the
  batch, so rows of one dispatch share a scale), the product runs int8 x
  int8 -> int32 (``torch._int_mm``; the reference leaves this plain
  product to XLA's ``dot_general``), then ``acc.float() * (sx * scale)``;
- :func:`qmatmul_row_parallel`: ``qmatmul`` of a row-parallel layer
  (``wo``, ``fc2``) over its tensor-parallel shards, as GSPMD runs the
  reference's: one amax over the whole activation (the max of the
  shards' amaxes), the shards' int32 accumulators summed in shard order,
  one dequantising multiply. Every step is exact, so it gives the
  unsharded product bit for bit. A column-parallel layer (``wq``, ``wk``,
  ``wv``, ``fc1``) needs nothing of its own: each shard quantises its
  replicated input alone, against the same amax, and holds its rows of
  the weight and of ``scale``;
- :class:`Int8Linear`: a ``Linear`` with an int8 ``weight`` buffer (torch's
  ``(out, in)`` layout) and a float32 per-output-channel ``scale``; the
  bias stays float and is added after the dequantising multiply;
- :func:`quantize_model`: swaps every ``Linear`` of a model for an
  ``Int8Linear``, in place. In a GPT that is the reference's
  ``_QUANT_WEIGHT_KEYS`` policy: the attention projections ``wq wk wv wo``
  and ``fc1``/``fc2``; embeddings, LayerNorm, biases and the tied head
  stay float.

The int32 accumulation is what makes the result the reference's: float32
sums of up to 3072 products of +-127 x +-127 are not exact, so a
dequantise-then-float-GEMM would compute another function.

LoRA (``models/lora.py``): :func:`lora_delta` is the reference's
``_lora_delta``, ``((x @ A) @ B) * s``, A first (rank is tiny), over
unbatched 2-D slabs with a scalar scale or over per-row (rows, in, r) /
(rows, r, out) slabs with a (rows,) scale (``torch.bmm``; the reference's
two ``jnp.einsum``, outside any Pallas kernel); an int8 slab ``{"q",
"scale"}`` dequantises in one multiply, and scale 0 (the pool's base row)
gives an exactly-zero delta. :func:`lora_down` and :func:`lora_up` are
its two products, apart for a row-parallel target under tensor
parallelism, whose rank-r partials are summed over the shards before B.
:func:`lora_linear` is ``qmatmul`` on a LoRA leaf: the base product, plus
the delta, then the bias.

``QuantizedLinear`` with a calibrated ``in_scale``,
``QuantizedSpatialConvolution`` and ``Quantizer`` need the Module-tree
containers and are not ported yet (ROADMAP A.9/A.11).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.utils.device import resolve_device

# torch._int_mm on CUDA takes more than 16 rows; a smaller batch (a decode
# step of 8 slots) is padded with zero rows after quantising, which change
# neither the amax nor any real row's result
_INT_MM_MIN_ROWS = 17


def scale_of(amax):
    """``max(amax, 1e-8) / 127`` in float32, divided as the reference
    divides. On CUDA, PyTorch turns a division by a Python number into a
    multiply by its reciprocal, which can differ in the last bit; a
    division by a tensor is the correctly rounded quotient on both
    devices."""
    amax = torch.clamp_min(amax.float(), 1e-8)
    return amax / torch.full_like(amax, 127.0)


def quantize_array(w, reduce_axes):
    """Symmetric int8 quantisation of ``w``: (int8 values, float32 scale
    shaped to broadcast back over ``w``)."""
    scale = scale_of(torch.amax(w.abs(), dim=reduce_axes, keepdim=True))
    return _quantize_with_scale(w, scale), scale


def _quantize_with_scale(x, scale):
    return torch.clamp(torch.round(x.float() / scale), -127, 127).to(
        torch.int8)


def _dynamic_quant(x):
    """Per-tensor symmetric activation quantisation: one amax over all of
    ``x``. Returns (int8 values, float32 scalar scale)."""
    scale = scale_of(x.abs().amax())
    return _quantize_with_scale(x, scale), scale


def _int_mm(a, b):
    """int8 (M, K) x int8 (K, N) -> int32 (M, N), exact."""
    m = a.shape[0]
    if m < _INT_MM_MIN_ROWS:
        a = torch.cat([a, a.new_zeros(_INT_MM_MIN_ROWS - m, a.shape[1])])
    return torch._int_mm(a, b)[:m]


def qmatmul(x, q, scale):
    """``x @ W`` for the int8 weight ``q`` (out, in) with float32 ``scale``
    (out,): the reference's ``qmatmul`` on a ``{"q": q.T, "scale":
    scale}`` leaf. Returns float32, or ``x.dtype`` for a low-precision
    float ``x``. ``qmatmul.calls`` counts the int8 products."""
    xq, sx = _dynamic_quant(x)
    acc = _int_mm(xq.reshape(-1, x.shape[-1]), q.t())
    y = acc.float() * (sx * scale)
    qmatmul.calls += 1
    if x.is_floating_point() and x.dtype != y.dtype:
        y = y.to(x.dtype)
    return y.reshape(*x.shape[:-1], q.shape[0])


qmatmul.calls = 0


def qmatmul_row_parallel(xs, qs, scale):
    """``sum_i xs[i] @ W_i`` for a row-parallel int8 weight split over its
    shards: ``xs[i]`` (..., in_i) and ``qs[i]`` int8 (out, in_i) on shard
    ``i``'s device, ``scale`` (out,) float32, whole on every shard (the
    first shard's copy is read). One activation scale from the max of the
    shards' amaxes; each shard's int8 product into int32; the int32 sum
    in shard order on the first shard's device; then ``acc.float() * (sx
    * scale)`` once, as :func:`qmatmul`. Returns it there, float32 (or
    ``xs[0].dtype`` for a low-precision float input). ``qmatmul.calls``
    counts each shard's product."""
    root = xs[0].device
    amax = torch.stack([x.abs().amax().float().to(root) for x in xs]).amax()
    sx = scale_of(amax)
    acc = None
    for x, q in zip(xs, qs):
        xq = _quantize_with_scale(x, sx.to(x.device))
        part = _int_mm(xq.reshape(-1, x.shape[-1]), q.t()).to(root)
        acc = part if acc is None else acc + part
        qmatmul.calls += 1
    y = acc.float() * (sx * scale.to(root))
    x = xs[0]
    if x.is_floating_point() and x.dtype != y.dtype:
        y = y.to(x.dtype)
    return y.reshape(*x.shape[:-1], qs[0].shape[0])


def _as(t, dtype):
    """``t`` in ``dtype``, with no call at all when it already is (the
    delta runs on a host-bound path: a no-op ``to`` still costs a
    dispatch)."""
    return t if t.dtype == dtype else t.to(dtype)


def _lora_slab(slab, dtype):
    """A LoRA slab in ``dtype``: an int8 ``{"q", "scale"}`` slab times its
    per-column scale (one multiply), a float slab as it is."""
    if isinstance(slab, dict):
        return slab["q"].to(dtype) * _as(slab["scale"], dtype)
    return _as(slab, dtype)


def lora_down(x, a):
    """The delta's first product ``x @ A`` (rank-r wide): unbatched ``a``
    (in, r), or batched ``a`` (rows, in, r) with ``x`` (rows, T, in).
    Counted in ``lora_delta.products``."""
    a = _lora_slab(a, x.dtype)
    lora_delta.products += 1
    return x @ a if a.dim() == 2 else torch.bmm(x, a)


def lora_up(u, b, s):
    """The delta's second product ``(u @ B) * s`` of a rank-r ``u``:
    unbatched ``b`` (r, out) and a Python-number ``s``, or batched ``b``
    (rows, r, out) and ``s`` (rows,). Counted in
    ``lora_delta.products``."""
    b = _lora_slab(b, u.dtype)
    lora_delta.products += 1
    if b.dim() == 2:
        return (u @ b) * s
    return torch.bmm(u, b) * _as(s, u.dtype)[:, None, None]


def lora_delta(x, a, b, s):
    """The low-rank delta ``((x @ A) @ B) * s`` (see module docstring):
    :func:`lora_up` of :func:`lora_down`. ``lora_delta.products`` counts
    every product of the delta."""
    return lora_up(lora_down(x, a), b, s)


lora_delta.products = 0


def lora_linear(lin, x, lo=None):
    """``lin(x)`` for a ``Linear`` or :class:`Int8Linear`, plus the LoRA
    delta of ``lo`` = ``(a, b, s)`` before the bias when given (the
    reference's ``qmatmul`` on a LoRA leaf, then ``Linear``'s bias). With
    ``lo`` None it is ``lin(x)``, nothing more."""
    if lo is None:
        return lin(x)
    if isinstance(lin, Int8Linear):
        y = qmatmul(x, lin.weight, lin.scale)
    else:
        y = F.linear(x, lin.weight)
    y = y + lora_delta(x, *lo)
    return y if lin.bias is None else y + lin.bias


class Int8Linear(nn.Module):
    """``Linear`` served from int8 weights (see module docstring). Buffers
    ``weight`` int8 (out, in) and ``scale`` float32 (out,); ``bias`` a
    float parameter or None."""

    def __init__(self, input_size, output_size, with_bias=True, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.input_size = input_size
        self.output_size = output_size
        device = resolve_device(device)
        self.register_buffer("weight", torch.zeros(
            output_size, input_size, dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.ones(
            output_size, dtype=torch.float32, device=device))
        if with_bias:
            self.bias = nn.Parameter(torch.zeros(output_size, device=device,
                                                 dtype=dtype))
        else:
            self.register_parameter("bias", None)

    @classmethod
    @torch.no_grad()
    def from_linear(cls, lin):
        """The int8 module of a float ``Linear``: per-output-channel
        :func:`quantize_array` of its weight, its bias kept."""
        w = lin.weight.detach()
        m = cls(lin.input_size, lin.output_size, lin.bias is not None,
                device=w.device, dtype=w.dtype)
        q, scale = quantize_array(w, reduce_axes=(1,))
        m.weight.copy_(q)
        m.scale.copy_(scale[:, 0])
        if lin.bias is not None:
            m.bias.copy_(lin.bias.detach())
        return m

    def forward(self, x):
        y = qmatmul(x, self.weight, self.scale)
        return y if self.bias is None else y + self.bias

    def extra_repr(self):
        return (f"{self.input_size} -> {self.output_size}, int8, "
                f"bias={self.bias is not None}")


def quantize_model(model):
    """Swap every ``Linear`` of ``model`` for its :class:`Int8Linear`, in
    place (already swapped modules stay as they are). Returns ``model``."""
    for parent in list(model.modules()):
        for name, child in list(parent.named_children()):
            if isinstance(child, Linear):
                setattr(parent, name, Int8Linear.from_linear(child))
    return model


__all__ = ["quantize_array", "qmatmul", "qmatmul_row_parallel",
           "lora_delta", "lora_linear", "Int8Linear", "quantize_model"]
