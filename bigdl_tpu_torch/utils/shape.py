"""Shape descriptors (the port of ``bigdl_tpu/utils/shape.py``: reference
``utils/Shape.scala``).

``SingleShape``/``MultiShape`` wrap shapes for API parity; :func:`to_spec`
turns shapes, tensors and arrays (or lists, tuples and dicts of them) into
specs: tensors on torch's ``meta`` device, which carry a shape and a dtype
and no data, where the reference builds ``jax.ShapeDtypeStruct``s.

:func:`trace_shapes` stands in for the reference's ``output_spec`` pass
(``jax.eval_shape`` through every layer): one forward of a CPU copy of the
model at batch 1, in evaluation mode, with forward hooks recording each
module's input and output shapes, the batch axis then set back to the
spec's. The copy's tensors are made on the CPU from the model's, so no
card memory is spent and no kernel launched; the port's kernel wrappers
take no ``meta`` tensors.
"""

from __future__ import annotations

import copy
import itertools

import numpy as np
import torch


class Shape:
    pass


class SingleShape(Shape):
    def __init__(self, dims):
        self.dims = tuple(int(d) for d in dims)

    def to_single(self):
        return self.dims

    def __eq__(self, other):
        return isinstance(other, SingleShape) and self.dims == other.dims

    def __repr__(self):
        return f"SingleShape{self.dims}"


class MultiShape(Shape):
    def __init__(self, shapes):
        self.shapes = list(shapes)

    def to_multi(self):
        return self.shapes

    def __repr__(self):
        return f"MultiShape{self.shapes}"


def shape_of(x):
    if isinstance(x, (list, tuple)):
        return MultiShape([shape_of(e) for e in x])
    return SingleShape(x.shape)


def _is_shape_tuple(v):
    return isinstance(v, tuple) and all(isinstance(d, (int, np.integer))
                                        for d in v)


def _dtype(dtype):
    """A torch dtype from a torch or numpy dtype."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, dtype)).dtype


def to_spec(x, dtype=None):
    """Shapes (tuples of ints, ``dtype`` or float32), tensors and arrays,
    and lists, tuples and dicts of them, as ``meta`` tensors of the same
    shapes and dtypes."""
    if isinstance(x, torch.Tensor):
        return torch.empty(tuple(x.shape), dtype=x.dtype, device="meta")
    if _is_shape_tuple(x):
        return torch.empty(tuple(int(d) for d in x),
                           dtype=_dtype(dtype) or torch.float32,
                           device="meta")
    if hasattr(x, "shape") and hasattr(x, "dtype"):
        return torch.empty(tuple(x.shape), dtype=_dtype(x.dtype),
                           device="meta")
    if isinstance(x, dict):
        return type(x)((k, to_spec(v, dtype)) for k, v in x.items())
    if isinstance(x, (list, tuple)):
        return type(x)(to_spec(v, dtype) for v in x)
    raise TypeError(f"cannot build spec from {type(x)}")


def _shapes(x, batch):
    """``x``'s shape(s), the leading axis of each set to ``batch``."""
    if isinstance(x, torch.Tensor):
        return (batch,) + tuple(x.shape[1:]) if x.dim() else ()
    if isinstance(x, (list, tuple)):
        return [_shapes(v, batch) for v in x]
    return None


def _zeros(spec):
    if isinstance(spec, torch.Tensor):
        return torch.zeros((1,) + tuple(spec.shape[1:]), dtype=spec.dtype)
    return [_zeros(s) for s in spec]


def _batch(spec):
    return spec.shape[0] if isinstance(spec, torch.Tensor) \
        else _batch(spec[0])


def _cpu_copy(model):
    """A deep copy of ``model`` whose parameters and buffers are new CPU
    tensors (the originals are never copied where they live), and whose
    recorded devices (a ``Graph``'s) are the CPU."""
    memo = {}
    for t in itertools.chain(model.parameters(), model.buffers()):
        c = t.detach().to("cpu", copy=True)
        memo[id(t)] = (torch.nn.Parameter(c, t.requires_grad)
                       if isinstance(t, torch.nn.Parameter) else c)
    return copy.deepcopy(model, memo).cpu()


def trace_shapes(model, input_spec):
    """``{id(module): (input shapes, output shapes)}`` for ``model`` and
    every module under it on ``input_spec`` (see module docstring; a
    module that does not run is absent). Raises where a layer does not fit
    its input, as the reference's build does."""
    spec = to_spec(input_spec)
    batch = _batch(spec)
    cpu = _cpu_copy(model).eval()
    ids = dict(zip((id(m) for m in cpu.modules()),
                   (id(m) for m in model.modules())))
    out = {}

    def hook(module, args, output):
        x = args[0] if len(args) == 1 else list(args)
        out[ids[id(module)]] = (_shapes(x, batch), _shapes(output, batch))

    handles = [m.register_forward_hook(hook) for m in cpu.modules()]
    try:
        with torch.no_grad():
            cpu(_zeros(spec))
    finally:
        for h in handles:
            h.remove()
    return out
