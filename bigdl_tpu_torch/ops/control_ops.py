"""Data-dependent control flow as modules (the port of
``bigdl_tpu/ops/control_ops.py``: reference ``nn/tf/ControlOps.scala``,
executed there by the interpreted ``DynamicGraph`` + ``Scheduler`` +
frame stack).

The structured forms are the reference's: :class:`Cond` (a Switch/Merge
pair), :class:`WhileLoop` (an Enter..Exit frame) and :class:`Select`
(element-wise where). The reference compiles them into one XLA program
(``lax.cond``, ``lax.while_loop``); here they run eagerly:

- ``Cond`` reads its predicate on the host (one synchronisation on the
  card) and runs only the selected branch. The other branch's parameters
  are tied into the output with a zero weight, so they get zero
  gradients, not ``None``, as ``lax.cond``'s gradient gives them: an
  optimizer such as Adam then steps every parameter the same way the
  reference's does;
- ``WhileLoop`` is a Python loop that reads ``cond_fn`` on the host each
  iteration (``host_syncs`` counts those reads); ``max_iters`` bounds it
  as in the reference (the body runs at most ``max_iters`` times).
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch.nn.module import Module, call_with_generator
from bigdl_tpu_torch.utils.table import Table, sorted_items


def _items(x):
    if isinstance(x, Table):
        return [v for _, v in sorted_items(x)]
    return list(x)


def _truth(v):
    """A scalar predicate (tensor, array or Python value) as a bool."""
    if isinstance(v, torch.Tensor):
        return bool(v.reshape(()).item())
    return bool(v)


def _tie_zero_grads(y, modules):
    """``y`` with the parameters of ``modules`` added at weight 0, so a
    backward pass gives them zero gradients; ``y`` itself (a tensor, or a
    list whose first floating tensor takes the tie) when none needs a
    gradient."""
    params = [p for m in modules for p in m.parameters() if p.requires_grad]
    if not params or not torch.is_grad_enabled():
        return y
    if isinstance(y, (list, tuple)):
        out = list(y)
        for i, v in enumerate(out):
            if isinstance(v, torch.Tensor) and v.is_floating_point():
                out[i] = _tie_zero_grads(v, modules)
                break
        return type(y)(out) if isinstance(y, tuple) else out
    if not (isinstance(y, torch.Tensor) and y.is_floating_point()):
        return y
    zero = sum((p * 0).sum() for p in params)
    return y + zero.to(y.dtype)


class Cond(Module):
    """``then_module`` or ``else_module`` on the data input, as a scalar
    boolean predicate says (module docstring). Input: ``[pred, data]``
    (a list or a Table), or the data alone with ``pred_fn`` deriving the
    predicate from it."""

    # the reference's params and state: {"then": ..., "else": ...}
    param_children = (("then_module", "then"), ("else_module", "else"))

    def __init__(self, then_module, else_module, pred_fn=None):
        super().__init__()
        self.then_module = then_module
        self.else_module = else_module
        self.pred_fn = pred_fn

    def _split(self, x):
        if self.pred_fn is not None:
            return self.pred_fn(x), x
        if isinstance(x, (Table, list, tuple)):
            items = _items(x)
            return items[0], items[1]
        raise ValueError("Cond expects Table(pred, data) or a pred_fn")

    def forward(self, x, generator=None):
        pred, data = self._split(x)
        if _truth(pred):
            taken, other = self.then_module, self.else_module
        else:
            taken, other = self.else_module, self.then_module
        y = call_with_generator(taken, data, generator)
        return _tie_zero_grads(y, [other])


class WhileLoop(Module):
    """``body_module`` applied while ``cond_fn`` holds (module docstring);
    the body maps the carry to a value of the same shape and dtype, as
    the reference's ``lax.while_loop`` requires."""

    param_children = (("body_module", None),)   # the body's own params

    def __init__(self, body_module, cond_fn, max_iters=None):
        super().__init__()
        self.body_module = body_module
        self.cond_fn = cond_fn
        self.max_iters = max_iters
        self.host_syncs = 0

    def forward(self, x, generator=None):
        i = 0
        while self.max_iters is None or i < self.max_iters:
            self.host_syncs += 1
            if not _truth(self.cond_fn(x)):
                break
            x = call_with_generator(self.body_module, x, generator)
            i += 1
        return x


class Select(Module):
    """Element-wise ``where(cond, a, b)`` over ``[cond, a, b]`` (a list or
    a Table; reference ``nn/ops/Select.scala``, TF ``Select(V2)``)."""

    def forward(self, *xs):
        x = xs[0] if len(xs) == 1 else list(xs)
        cond, a, b = _items(x)
        return torch.where(cond.bool(), a, b)
