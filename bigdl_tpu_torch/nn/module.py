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
- ``regularized_leaves()``: the ``(parameter name, regularizer)`` pairs
  a layer's regularizers penalise (default ``weight`` by
  ``w_regularizer`` and ``bias`` by ``b_regularizer``; a recurrent cell's
  are its input, recurrent and bias weights);
- :func:`jax_perm`: how a layer's tensor is laid out against the
  reference's (``jax_perms``, a class's own table, over the default:
  a 4-D ``weight`` OIHW for the reference's HWIO, a 2-D one (out, in) for
  its (in, out)); :func:`jax_layout` generalises it to a permutation of a
  view (a class's own ``jax_layout`` method: the transposed convolution's
  grouped weight), and :func:`to_jax_layout`/:func:`from_jax_layout`
  apply it to a tensor or an array either way;
- ``save_module(path, weight_path=None, overwrite=False)``: the module
  in the native model format (``utils/serializer.py``; its
  ``load_module`` reads it back);
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

    def regularized_leaves(self):
        """``[(own parameter name, regularizer)]`` (module docstring)."""
        return [("weight", self.w_regularizer), ("bias", self.b_regularizer)]

    def save_module(self, path, weight_path=None, overwrite=False):
        """Write this module in the native format
        (``utils/serializer.py`` ``save_module``); returns the module."""
        from bigdl_tpu_torch.utils.serializer import save_module
        save_module(self, path, weight_path=weight_path, overwrite=overwrite)
        return self


class Criterion(nn.Module):
    """Loss base (the reference's ``Criterion``, ``AbstractCriterion``):
    ``forward(input, target)`` is the scalar loss, without side effects
    (the reference's pure ``apply``, which its ``__call__`` is);
    ``backward(input, target)`` is its gradient for ``input`` through
    autograd (the reference's vjp), a tensor, or a table (list) of them
    where ``input`` is one, kept as ``grad_input`` with the loss as
    ``output``."""

    def __init__(self, size_average=True):
        super().__init__()
        self.size_average = size_average
        self.output = None
        self.grad_input = None

    def forward(self, input, target=None):
        raise NotImplementedError

    def backward(self, input, target=None):
        leaves = []

        def leaf(x):
            if isinstance(x, torch.Tensor) and x.is_floating_point():
                x = x.detach().requires_grad_(True)
                leaves.append(x)
            return x

        def walk(x, fn):
            if isinstance(x, dict):
                return type(x)((k, walk(v, fn)) for k, v in x.items())
            if isinstance(x, (list, tuple)):
                return type(x)(walk(v, fn) for v in x)
            return fn(x)

        x = walk(input, leaf)
        with torch.enable_grad():
            loss = self.forward(x, target)
            grads = iter(torch.autograd.grad(loss, leaves,
                                             allow_unused=True))
        by_id = {id(t): g if g is not None else torch.zeros_like(t)
                 for t, g in zip(leaves, grads)}
        self.output = loss.detach()
        self.grad_input = walk(x, lambda t: by_id.get(id(t), t))
        return self.grad_input


_DEFAULT_PERMS = {4: (2, 3, 1, 0), 2: (1, 0)}


def jax_perm(module, leaf, ndim):
    """The permutation that puts ``module``'s tensor ``leaf`` (of ``ndim``
    dimensions) in the reference's layout, or None when the layouts agree
    (module docstring)."""
    perms = getattr(module, "jax_perms", None) or {}
    if leaf in perms:
        return perms[leaf]
    return _DEFAULT_PERMS.get(ndim) if leaf == "weight" else None


def jax_layout(module, leaf, shape):
    """``(view, perm, reference shape)``: ``module``'s tensor ``leaf`` of
    ``shape``, viewed as ``view`` and permuted by ``perm``, is the
    reference's array reshaped to ``reference shape``; None when the
    layouts agree. A class's own ``jax_layout(leaf, shape)`` method
    decides first (None there: no layout of its own for that leaf), then
    :func:`jax_perm`."""
    own = getattr(module, "jax_layout", None)
    layout = own(leaf, tuple(shape)) if own is not None else None
    if layout is not None:
        return layout
    perm = jax_perm(module, leaf, len(shape))
    if perm is None:
        return None
    return tuple(shape), perm, tuple(shape[i] for i in perm)


def _permute(x, perm):
    return x.permute(*perm) if isinstance(x, torch.Tensor) \
        else x.transpose(perm)


def to_jax_layout(layout, x):
    """A port tensor or array ``x`` in the reference's layout (``layout``
    from :func:`jax_layout`; None: ``x`` as it is)."""
    if layout is None:
        return x
    view, perm, shape = layout
    return _permute(x.reshape(view), perm).reshape(shape)


def from_jax_layout(layout, shape, a):
    """The inverse of :func:`to_jax_layout`: the reference's ``a`` as the
    port's tensor or array of ``shape``."""
    if layout is None:
        return a
    view, perm, _ = layout
    inverse = tuple(int(i) for i in np.argsort(perm))
    return _permute(a.reshape(tuple(view[i] for i in perm)),
                    inverse).reshape(shape)


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
    """``[(parameter name, regularizer)]`` of every set regularizer that
    a layer's ``regularized_leaves()`` names under ``module`` (a module
    shared by several containers counts once; a module that is not the
    port's carries none)."""
    out = []
    seen = set()
    for prefix, m, _ in _walk(module):
        if id(m) in seen:
            continue
        seen.add(id(m))
        leaves = getattr(m, "regularized_leaves", None)
        for leaf, reg in (leaves() if leaves is not None else ()):
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
