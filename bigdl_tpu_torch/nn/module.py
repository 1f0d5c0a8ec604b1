"""The module hooks of the reference's ``Module`` (the port of
``bigdl_tpu/nn/module.py``: names, freeze, gradient scales, regularizers,
``reset`` and the graph-node call).

The port's layers are ``torch.nn.Module``s; :class:`Module` adds what the
reference's training API reads from them:

- ``set_name``/``get_name``;
- ``freeze()``/``unfreeze()`` and ``set_scale_w``/``set_scale_b``:
  per-parameter gradient multipliers, read by :func:`grad_scales` (0 under
  a frozen module or any frozen ancestor; else the owning layer's
  ``scale_b`` for a ``bias`` and ``scale_w`` for any other parameter), as
  the reference's ``grad_scale_tree`` does;
- ``w_regularizer``/``b_regularizer``, listed by :func:`regularizers` and
  summed by :func:`regularization_loss`;
- ``evaluate()`` (torch's ``eval()``; the reference's ``training()`` is
  torch's ``train()``: ``training`` is torch's mode flag);
- ``reset(seed)``: seeded weights from the reference's initializers'
  distributions (see :func:`init_state_dict`);
- ``layer(node)`` on graph nodes builds a :class:`Node` (``nn/graph.py``),
  as in the reference; on tensors it is the forward;
- :func:`takes_generator`: does a module's ``forward`` take the
  ``generator`` its layers draw from (``Dropout``, the containers, the
  GPT and ResNet models)? The reference hands its rng to every layer and
  the layers that draw nothing ignore it; here only such a forward gets
  one.
"""

from __future__ import annotations

import functools
import inspect

import numpy as np
import torch
from torch import nn


class Node:
    """A module placed in a graph, with the nodes that feed it (reference
    ``nn/graph.py`` ``Node``)."""

    _counter = [0]

    def __init__(self, module):
        self.module = module
        self.prev_nodes = []
        Node._counter[0] += 1
        self.id = Node._counter[0]

    def inputs(self, *nodes):
        for n in nodes:
            if not isinstance(n, Node):
                raise TypeError("graph inputs must be Nodes")
            self.prev_nodes.append(n)
        return self

    def __repr__(self):
        return f"Node({self.module!r})"


class Module(nn.Module):
    """Base of the port's layers (see module docstring)."""

    w_regularizer = None
    b_regularizer = None
    _frozen = False
    _scale_w = 1.0
    _scale_b = 1.0

    def __call__(self, *args, **kwargs):
        if args and isinstance(args[0], Node) \
                and all(isinstance(a, Node) for a in args):
            return Node(self).inputs(*args)
        return super().__call__(*args, **kwargs)

    def inputs(self, *nodes):
        return Node(self).inputs(*nodes)

    def set_name(self, name):
        self._bigdl_name = name
        return self

    def get_name(self):
        return getattr(self, "_bigdl_name", type(self).__name__)

    def freeze(self):
        self._frozen = True
        return self

    def unfreeze(self):
        self._frozen = False
        return self

    def set_scale_w(self, w):
        self._scale_w = w
        return self

    def set_scale_b(self, b):
        self._scale_b = b
        return self

    def evaluate(self):
        return self.eval()

    def reset(self, seed=1):
        """Seeded weights for every layer under this module (see
        :func:`init_state_dict`); returns the module."""
        self.load_state_dict(init_state_dict(self, seed), strict=False)
        return self

    def init_arrays(self, rng):
        """This layer's own parameters drawn from ``rng`` (a numpy
        generator) as ``{name: float32 array}`` in the port's layout;
        layers without parameters draw nothing."""
        return {}


@functools.cache
def _forward_takes_generator(cls):
    return "generator" in inspect.signature(cls.forward).parameters


def takes_generator(module):
    """Does ``module.forward`` take a ``generator`` keyword?"""
    return _forward_takes_generator(type(module))


def call_with_generator(module, x, generator):
    """``module(x)``, with ``generator=`` where it is given and the
    module's forward takes it."""
    if generator is not None and takes_generator(module):
        return module(x, generator=generator)
    return module(x)


def _walk(module, prefix="", frozen=False):
    """``(prefix, module, frozen)`` for ``module`` and every descendant,
    ``frozen`` true under a frozen module or ancestor."""
    frozen = frozen or getattr(module, "_frozen", False)
    yield prefix, module, frozen
    for name, child in module.named_children():
        yield from _walk(child, f"{prefix}{name}.", frozen)


def grad_scales(module):
    """``{parameter name: multiplier}`` for every parameter of ``module``
    (see module docstring)."""
    out = {}
    for prefix, m, frozen in _walk(module):
        for name, _ in m.named_parameters(recurse=False):
            if frozen:
                s = 0.0
            elif name == "bias":
                s = getattr(m, "_scale_b", 1.0)
            else:
                s = getattr(m, "_scale_w", 1.0)
            out.setdefault(prefix + name, s)
    return out


def regularizers(module):
    """``[(parameter name, regularizer)]`` of every ``w_regularizer`` /
    ``b_regularizer`` under ``module`` (a module shared by several
    containers counts once)."""
    out = []
    seen = set()
    for prefix, m, _ in _walk(module):
        if id(m) in seen:
            continue
        seen.add(id(m))
        for leaf, reg in (("weight", getattr(m, "w_regularizer", None)),
                          ("bias", getattr(m, "b_regularizer", None))):
            if reg is not None and getattr(m, leaf, None) is not None:
                out.append((prefix + leaf, reg))
    return out


def regularization_loss(module, params=None):
    """The sum of the penalties of :func:`regularizers` on ``params``
    (name -> tensor, e.g. a cast copy; default the module's own
    parameters); 0.0 when no layer carries a regularizer."""
    if params is None:
        params = dict(module.named_parameters())
    total = 0.0
    for name, reg in regularizers(module):
        total = total + reg(params[name])
    return total


def init_state_dict(module, seed=1):
    """Seeded weights for every layer under ``module`` that draws them
    (``init_arrays``), as a partial ``state_dict`` of float32 CPU tensors,
    from ``np.random.default_rng(seed)`` in the layers' order. The
    distributions are the reference's default initializers': ``Linear``
    weight and bias uniform in +-1/sqrt(in) (``RandomUniform``),
    convolution weights Glorot-uniform (``Xavier``) and biases 0, BN
    weight 1 and bias 0. The numbers are numpy's, not JAX's: weights
    carried from the reference go through ``convert``."""
    rng = np.random.default_rng(seed)
    sd = {}
    for prefix, m, _ in _walk(module):
        draw = getattr(m, "init_arrays", None)
        if draw is None:
            continue
        for name, a in draw(rng).items():
            sd[prefix + name] = torch.from_numpy(
                np.ascontiguousarray(a, dtype=np.float32))
    return sd
