"""Containers (the port of ``bigdl_tpu/nn/containers.py``: ``Sequential``,
``Concat``, ``ConcatTable``, ``ParallelTable``, ``MapTable``, ``Bottle``).

Children are registered under their list index, so a ``state_dict`` key is
``"<i>.<leaf>"`` (nested: ``"<i>.<j>.<leaf>"``), the path of the
reference's list-of-children params; ``convert.module_params_from_jax``
carries those across. ``add()`` returns the container, so the reference's
chained builders read the same. The reference's Table (keys 1..n) is a
Python list: ``ConcatTable``/``ParallelTable``/``MapTable`` return lists,
and ``ParallelTable``/``MapTable`` take a list or tuple. The reference's
``modules`` list is ``container[i]``, ``len(container)`` and iteration
here (``modules`` is torch's method).

``MapTable`` and ``Bottle`` hold ONE child whose parameters every
application shares, as the reference's do; ``freeze``/``unfreeze`` reach
every child (``nn/module.py`` reads the flags).

Each container's ``forward`` takes ``generator=None`` and hands it to
every child whose ``forward`` takes one (``Dropout``, nested containers),
as the reference's containers pass their rng down; the children draw
from it in forward order.
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch.nn.module import Module, call_with_generator


class Container(Module):
    def __init__(self, *modules):
        super().__init__()
        for m in modules:
            self.add(m)

    def add(self, module):
        self.add_module(str(len(self._modules)), module)
        return self

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, i):
        return list(self._modules.values())[i]

    def __iter__(self):
        return iter(self._modules.values())

    def freeze(self):
        super().freeze()
        for m in self:
            if hasattr(m, "freeze"):
                m.freeze()
        return self

    def unfreeze(self):
        super().unfreeze()
        for m in self:
            if hasattr(m, "unfreeze"):
                m.unfreeze()
        return self


class Sequential(Container):
    """Reference ``nn/Sequential.scala:31``."""

    def forward(self, x, generator=None):
        for m in self._modules.values():
            x = call_with_generator(m, x, generator)
        return x


class Concat(Container):
    """Each child on the same input, outputs concatenated along
    ``dimension`` (0-based, as in the reference)."""

    def __init__(self, dimension=1):
        super().__init__()
        self.dimension = dimension

    def forward(self, x, generator=None):
        return torch.cat([call_with_generator(m, x, generator)
                          for m in self._modules.values()],
                         dim=self.dimension)


class ConcatTable(Container):
    """Each child on the same input; the list of their outputs."""

    def forward(self, x, generator=None):
        return [call_with_generator(m, x, generator)
                for m in self._modules.values()]


class ParallelTable(Container):
    """Child i on element i of the input list."""

    def forward(self, xs, generator=None):
        return [call_with_generator(m, x, generator)
                for m, x in zip(self._modules.values(), xs)]


class MapTable(Container):
    """One shared child on every element of the input list."""

    def __init__(self, module=None):
        super().__init__()
        if module is not None:
            self.add(module)

    def forward(self, xs, generator=None):
        m = self[0]
        return [call_with_generator(m, x, generator) for x in xs]


class Bottle(Container):
    """The child on the input with its leading axes flattened into one,
    which are then restored (reference ``nn/Bottle.scala``)."""

    def __init__(self, module, n_input_dim=2, n_output_dim=None):
        super().__init__(module)
        self.n_input_dim = n_input_dim
        self.n_output_dim = n_output_dim or n_input_dim

    def forward(self, x, generator=None):
        tail = self.n_input_dim - 1
        lead_shape = x.shape[:-tail]
        flat = x.reshape((-1,) + tuple(x.shape[-tail:]))
        y = call_with_generator(self[0], flat, generator)
        return y.reshape(tuple(lead_shape) + tuple(y.shape[1:]))
