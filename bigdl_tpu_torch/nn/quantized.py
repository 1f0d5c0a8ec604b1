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

Post-training quantisation (the reference's ``QuantizedLinear``,
``QuantizedSpatialConvolution``, ``QuantizedSpatialDilatedConvolution``
and ``Quantizer``, ``nn/quantized.py:178-437``):

- each quantised layer holds its weight as int8 buffers with a float32
  scale per output channel (``quantize_array``), its float bias, and an
  optional float32 ``in_scale``: the activation is quantised against it
  when present (a calibrated, static threshold), else against its own
  amax (dynamic). The product accumulates in int32, one multiply
  dequantises (``acc * (sx * scale)``), the bias is added in float32 and
  a low-precision float input's type is kept;
- :class:`QuantizedSpatialConvolution` lowers the int8 convolution to an
  int8 im2col (:func:`im2col`, SAME padding as XLA's, strides, dilation;
  NCHW or NHWC) and one ``torch._int_mm`` a group, K and N zero-padded to
  multiples of 8 and M to 17 rows (what CUDA's int8 product takes; zeros
  are exact). PyTorch has no int8 convolution on CUDA, and a float32
  convolution of int8 values is not exact past 2^24 / 127^2 (about 1040)
  products a sum, which ResNet-50's 3x3 x 512 (4608) passes. The
  reference leaves this convolution to XLA outside any Pallas kernel;
- :class:`Quantizer` ``quantize(model, calib_input=None)`` deep-copies the
  model (the source keeps its layers and no threshold), swaps every
  ``Linear`` (exactly) and ``SpatialConvolution`` (dilated or not) of its
  ``Sequential``/``Concat`` containers, ``Graph`` nodes and ResNet layers
  for its quantised form, and returns it in evaluation mode. With
  ``calib_input``, one forward in evaluation mode with a forward pre-hook
  on every swappable layer first records each layer's largest input amax
  (a layer called twice keeps the larger); the hooks are removed even
  when the forward raises. The port's layers own their weights from
  construction, so the reference's error for an unbuilt model has no
  counterpart.
"""

from __future__ import annotations

import copy
import sys

import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch.nn.conv import (SpatialConvolution,
                                     SpatialDilatedConvolution)
from bigdl_tpu_torch.nn.graph import Graph
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.module import Module
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
    """int8 (M, K) x int8 (K, N) -> int32 (M, N), exact; ``b`` the
    transpose of a row-major (N, K) weight. K and N are zero-padded to
    multiples of 8 and M to 17 rows where they fall short (CUDA's int8
    product takes no less), the result cut back."""
    m, k = a.shape
    n = b.shape[1]
    pk, pn = -k % 8, -n % 8
    if pk or pn:
        a = F.pad(a, (0, pk))
        b = F.pad(b.t(), (0, pk, 0, pn)).t()
    if m < _INT_MM_MIN_ROWS:
        a = torch.cat([a, a.new_zeros(_INT_MM_MIN_ROWS - m, a.shape[1])])
    return torch._int_mm(a, b)[:m, :n]


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


def _in_scale(amax):
    """The static activation scale of a calibrated amax, as the
    reference computes it: ``float32(max(amax, 1e-8) / 127)`` in Python
    floats."""
    return torch.tensor(max(amax, 1e-8) / 127.0, dtype=torch.float32)


def _quant_input(x, in_scale):
    """(int8 activation, float32 scale): against ``in_scale`` when given,
    else the dynamic per-tensor amax."""
    if in_scale is not None:
        return _quantize_with_scale(x, in_scale), in_scale
    return _dynamic_quant(x)


def _finish(acc, sx, scale, bias, x):
    """``acc * (sx * scale) + bias`` in float32, in a low-precision float
    ``x``'s type."""
    y = acc.float() * (sx * scale)
    if bias is not None:
        y = y + bias
    if x.is_floating_point() and x.dtype != y.dtype:
        y = y.to(x.dtype)
    return y


class _Quantized(Module):
    """int8 ``weight`` and float32 ``scale`` buffers, the float ``bias``
    and the optional ``in_scale`` buffer (module docstring); the buffers
    are the reference's params (``param_buffers``, read by
    ``convert``)."""

    param_buffers = ("weight", "scale", "in_scale")

    def _init_buffers(self, wshape, n_out, with_bias, device, dtype):
        self.register_buffer("weight", torch.zeros(wshape, dtype=torch.int8,
                                                   device=device))
        self.register_buffer("scale", torch.ones(n_out, device=device))
        self.register_buffer("in_scale", None)
        if with_bias:
            self.bias = nn.Parameter(torch.zeros(n_out, device=device,
                                                 dtype=dtype))
        else:
            self.register_parameter("bias", None)

    def _fill(self, src, reduce_axes):
        """Quantise ``src``'s float weight into this layer, with its bias
        and, when ``src`` was calibrated, its static scale."""
        q, scale = quantize_array(src.weight.detach(), reduce_axes)
        self.weight.copy_(q)
        self.scale.copy_(scale.reshape(-1))
        if src.bias is not None:
            self.bias.data.copy_(src.bias.detach())
        amax = getattr(src, "_calib_amax", None)
        if amax is not None:
            self.in_scale = _in_scale(amax).to(self.scale.device)
        return self


class QuantizedLinear(_Quantized):
    """(reference ``nn/quantized/Linear.scala:79``) ``weight`` int8 (out,
    in), torch's layout (``convert`` transposes the reference's (in,
    out))."""

    def __init__(self, input_size, output_size, with_bias=True, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.input_size, self.output_size = input_size, output_size
        self._init_buffers((output_size, input_size), output_size,
                           with_bias, resolve_device(device), dtype)

    @classmethod
    @torch.no_grad()
    def from_float(cls, module):
        w = module.weight
        return cls(module.input_size, module.output_size,
                   module.bias is not None, device=w.device,
                   dtype=w.dtype)._fill(module, (1,))

    def accumulate(self, xq):
        """The int32 accumulator of an int8 activation (..., in)."""
        acc = _int_mm(xq.reshape(-1, self.input_size), self.weight.t())
        return acc.reshape(*xq.shape[:-1], self.output_size)

    def forward(self, x):
        xq, sx = _quant_input(x, self.in_scale)
        return _finish(self.accumulate(xq), sx, self.scale, self.bias, x)

    def __repr__(self):
        return f"QuantizedLinear({self.input_size} -> {self.output_size})"


def im2col(x, kernel_hw, stride=(1, 1), padding=((0, 0), (0, 0)),
           dilation=(1, 1)):
    """The patch matrix of an NHWC ``x`` (any type): ``(N * Ho * Wo, kh *
    kw * C)``, columns in (kh, kw, C) order, zero-padded by ``padding``
    ((top, bottom), (left, right)); returns it and (N, Ho, Wo)."""
    kh, kw = kernel_hw
    (sh, sw), (dh, dw) = stride, dilation
    (t, b), (l, r) = padding
    if t or b or l or r:
        x = F.pad(x, (0, 0, l, r, t, b))
    n, hp, wp, c = x.shape
    ho = (hp - (kh - 1) * dh - 1) // sh + 1
    wo = (wp - (kw - 1) * dw - 1) // sw + 1
    if kh == kw == 1:
        cols = x[:, :(ho - 1) * sh + 1:sh, :(wo - 1) * sw + 1:sw]
    else:
        cols = torch.stack(
            [x[:, i * dh:i * dh + (ho - 1) * sh + 1:sh,
               j * dw:j * dw + (wo - 1) * sw + 1:sw]
             for i in range(kh) for j in range(kw)], dim=3)
    return cols.reshape(n * ho * wo, kh * kw * c), (n, ho, wo)


class QuantizedSpatialConvolution(_Quantized):
    """(reference ``nn/quantized/SpatialConvolution.scala:197``) the
    geometry of the float layer ``src``; ``weight`` int8 OIHW in
    channels-last memory (O, kh, kw, I/groups), whose rows are the
    im2col columns' order (module docstring)."""

    def __init__(self, src):
        super().__init__()
        for attr in ("n_input_plane", "n_output_plane", "kernel_w",
                     "kernel_h", "stride_w", "stride_h", "pad_w", "pad_h",
                     "n_group", "format", "dilation_w", "dilation_h"):
            setattr(self, attr, getattr(src, attr))
        w = src.weight
        self._init_buffers(tuple(w.shape), self.n_output_plane,
                           src.bias is not None, w.device, w.dtype)
        self.weight = self.weight.to(memory_format=torch.channels_last)

    # the float layer's padding rule (SAME over the dilated extent)
    _extent = SpatialConvolution._extent
    padding = SpatialConvolution.padding
    output_hw = SpatialConvolution.output_hw

    @classmethod
    @torch.no_grad()
    def from_float(cls, module):
        return cls(module)._fill(module, (1, 2, 3))

    def accumulate(self, xq):
        """The int32 accumulator of an int8 activation in the layer's
        format, in that format."""
        nhwc = self.format == "NHWC"
        x = xq if nhwc else xq.permute(0, 2, 3, 1)
        cols, (n, ho, wo) = im2col(
            x, (self.kernel_h, self.kernel_w),
            (self.stride_h, self.stride_w), self.padding(*x.shape[1:3]),
            (self.dilation_h, self.dilation_w))
        g = self.n_group
        w = self.weight.permute(0, 2, 3, 1)          # (O, kh, kw, I/g)
        if g == 1:
            acc = _int_mm(cols, w.reshape(w.shape[0], -1).t())
        else:
            kk = self.kernel_h * self.kernel_w
            ci, co = self.n_input_plane // g, self.n_output_plane // g
            parts = cols.view(cols.shape[0], kk, g, ci)
            acc = torch.cat(
                [_int_mm(parts[:, :, i].reshape(cols.shape[0], kk * ci),
                         w[i * co:(i + 1) * co].reshape(co, -1).t())
                 for i in range(g)], dim=1)
        acc = acc.reshape(n, ho, wo, -1)
        return acc if nhwc else acc.permute(0, 3, 1, 2)

    def forward(self, x):
        xq, sx = _quant_input(x, self.in_scale)
        shape = (1, 1, 1, -1) if self.format == "NHWC" else (1, -1, 1, 1)
        bias = None if self.bias is None else self.bias.reshape(shape)
        return _finish(self.accumulate(xq), sx, self.scale.reshape(shape),
                       bias, x)

    def __repr__(self):
        return (f"QuantizedSpatialConvolution({self.n_input_plane} -> "
                f"{self.n_output_plane}, {self.kernel_w}x{self.kernel_h})")


class QuantizedSpatialDilatedConvolution(QuantizedSpatialConvolution):
    """(reference ``nn/quantized/SpatialDilatedConvolution.scala:30``) the
    same int8 convolution, a type of its own as in the reference."""

    def __repr__(self):
        return (f"QuantizedSpatialDilatedConvolution({self.n_input_plane} "
                f"-> {self.n_output_plane}, "
                f"{self.kernel_w}x{self.kernel_h}, "
                f"dilation {self.dilation_w}x{self.dilation_h})")


def _walked(module):
    """Does :class:`Quantizer` walk ``module``'s children? Those whose
    class sets ``quantizer_walks``: containers, graphs and the ResNet
    model (the reference's ResNet is a Graph)."""
    return getattr(module, "quantizer_walks", False)


def _swappable(module):
    return type(module) is Linear or isinstance(module, SpatialConvolution)


class Quantizer:
    """Post-training quantiser (reference ``Quantizer.scala:27``; module
    docstring)."""

    @staticmethod
    def quantize(model, calib_input=None):
        amax = ({} if calib_input is None
                else Quantizer._calibrate(model, calib_input))
        memo = {}
        # deep Graph node chains recurse past Python's default limit
        old_limit = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old_limit, 50_000))
        try:
            m = copy.deepcopy(model, memo)
        finally:
            sys.setrecursionlimit(old_limit)
        for key, a in amax.items():
            memo[key]._calib_amax = a      # the copy's layers only
        Quantizer._walk(m)
        return m.eval()

    @staticmethod
    def _iter_swappable(module):
        for child in module.children():
            if _swappable(child):
                yield child
            elif _walked(child):
                yield from Quantizer._iter_swappable(child)

    @staticmethod
    @torch.no_grad()
    def _calibrate(model, calib_input):
        """``{id(layer): its largest input amax}`` over one forward of
        ``calib_input`` in evaluation mode."""
        seen = []
        mods = [m for m in Quantizer._iter_swappable(model)
                if not any(m is s for s in seen) and not seen.append(m)]
        stash = []

        def hook(mod, args):
            xx = args[0] if args else None
            if torch.is_tensor(xx) and xx.is_floating_point():
                stash.append((id(mod), xx.abs().amax().float()))

        handles = []
        was = model.training
        try:
            for mod in mods:
                handles.append(mod.register_forward_pre_hook(hook))
            model.eval()
            model(calib_input)
        finally:
            for h in handles:
                h.remove()
            model.train(was)
        amax = {}
        values = torch.stack([a for _, a in stash]).cpu().tolist() \
            if stash else []
        for (key, _), v in zip(stash, values):
            amax[key] = max(amax.get(key, 0.0), v)
        return amax

    @staticmethod
    def _swap(module):
        if type(module) is Linear:
            return QuantizedLinear.from_float(module)
        if isinstance(module, SpatialDilatedConvolution):
            return QuantizedSpatialDilatedConvolution.from_float(module)
        if isinstance(module, SpatialConvolution):
            return QuantizedSpatialConvolution.from_float(module)
        return None

    @staticmethod
    def _walk(module):
        for name, child in list(module.named_children()):
            q = Quantizer._swap(child)
            if q is None:
                if _walked(child):
                    Quantizer._walk(child)
                continue
            module._modules[name] = q
            if isinstance(module, Graph):
                for node in module.exec_order:
                    if node.module is child:
                        node.module = q


__all__ = ["quantize_array", "qmatmul", "qmatmul_row_parallel",
           "lora_delta", "lora_linear", "Int8Linear", "quantize_model",
           "QuantizedLinear", "QuantizedSpatialConvolution",
           "QuantizedSpatialDilatedConvolution", "Quantizer", "im2col"]
