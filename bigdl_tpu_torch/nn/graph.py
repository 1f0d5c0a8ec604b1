"""DAG models (the port of ``bigdl_tpu/nn/graph.py``: ``Node``, ``Input``,
``Graph``).

A graph is wired with the reference's node calls: ``x = layer(node)``.
``Graph(inputs, outputs)`` orders the nodes reachable from the outputs
by the reference's reverse depth-first walk, raises on a cycle and on an
input that reaches no output, and registers each node's module under its
place in that order, so a ``state_dict`` key is ``"<i>.<leaf>"``
(``convert.module_params_from_jax`` maps the reference's node-id keys by
the same order). A node fed by several nodes receives the list of their
outputs, in wiring order; several graph inputs take a list or tuple, or a
``utils.table.Table``, whose values feed them in sorted-key order; a
graph with several outputs returns a list. A node with no inputs that is
not a graph input must be a source (its module sets ``is_source``, as the
TF loader's ``ConstSource`` and ``RandomUniform`` do) and is called with
``None``. ``forward`` hands its ``generator`` to every node's module whose
``forward`` takes one.

Host values: a module whose class sets ``host_side`` (the TF string and
data ops of ``ops/tf_ops.py``) takes and gives numpy arrays. Any other
module gets each numeric numpy array of its input as a tensor on the
graph's ``device`` (64-bit types as the reference's 32-bit ones), and
numpy arrays of strings or bytes as they are; so do the graph's outputs.
``Graph(..., device=)`` records that device (the TF loader records the
one it builds on), and moving the graph (``.to``, ``.cuda``, ``.cpu``)
moves it; without one it is the card, as for every entry point
(``utils.device.resolve_device``), so a graph fed host values never runs
on the CPU unless asked to.
"""

from __future__ import annotations

import numpy as np
import torch

from bigdl_tpu_torch.nn.basic import Input as InputModule
from bigdl_tpu_torch.nn.module import Module, Node, call_with_generator
from bigdl_tpu_torch.utils.device import resolve_device
from bigdl_tpu_torch.utils.table import Table, sorted_items

__all__ = ["Graph", "Input", "Node"]


def Input():
    """A graph input placeholder node (reference ``nn/Input.scala``)."""
    return Node(InputModule())


class Graph(Module):
    """Static DAG module (reference ``nn/Graph.scala:72``)."""

    quantizer_walks = True    # nn.quantized.Quantizer swaps in nodes

    def __init__(self, inputs, outputs, device=None):
        super().__init__()
        self.device = None if device is None else torch.device(device)
        self.input_nodes = (list(inputs) if isinstance(inputs, (list, tuple))
                            else [inputs])
        self.output_nodes = (list(outputs)
                             if isinstance(outputs, (list, tuple))
                             else [outputs])
        self.exec_order = self._topo_sort()
        for i, node in enumerate(self.exec_order):
            self.add_module(str(i), node.module)

    def _topo_sort(self):
        order, visiting, visited = [], set(), set()

        def visit(node):
            if node.id in visited:
                return
            if node.id in visiting:
                raise ValueError("cycle detected in Graph")
            visiting.add(node.id)
            for p in node.prev_nodes:
                visit(p)
            visiting.discard(node.id)
            visited.add(node.id)
            order.append(node)

        for out in self.output_nodes:
            visit(out)
        for inp in self.input_nodes:
            if inp.id not in visited:
                raise ValueError("graph input not connected to any output")
        return order

    def _gather_input(self, node, values, graph_input):
        if not node.prev_nodes:
            if node not in self.input_nodes:
                if getattr(node.module, "is_source", False):
                    return None
                raise ValueError(
                    f"graph node {node.module.get_name()} has no inputs and "
                    "is not a graph input (set is_source=True on modules "
                    "that generate their own output)")
            if isinstance(graph_input, (Table, list, tuple)) \
                    and len(self.input_nodes) > 1:
                elems = ([v for _, v in sorted_items(graph_input)]
                         if isinstance(graph_input, Table)
                         else list(graph_input))
                return elems[self.input_nodes.index(node)]
            return graph_input
        if len(node.prev_nodes) == 1:
            return values[node.prev_nodes[0].id]
        return [values[p.id] for p in node.prev_nodes]

    def _apply(self, fn, *args, **kwargs):
        # a move of the graph's tensors moves its recorded device
        if self.device is not None:
            self.device = fn(torch.empty(0, device=self.device)).device
        return super()._apply(fn, *args, **kwargs)

    def forward(self, x, generator=None):
        values = {}
        for node in self.exec_order:
            inp = self._gather_input(node, values, x)
            if not getattr(node.module, "host_side", False) \
                    and _has_host(inp):
                inp = _on_device(inp, resolve_device(self.device))
            values[node.id] = call_with_generator(node.module, inp,
                                                  generator)
        outs = [values[n.id] for n in self.output_nodes]
        if any(_has_host(o) for o in outs):
            outs = [_on_device(o, resolve_device(self.device)) for o in outs]
        return outs[0] if len(outs) == 1 else outs


def _has_host(v):
    """Is ``v`` (or an element of the list ``v``) a numeric numpy array?"""
    if isinstance(v, np.ndarray):
        return v.dtype != object
    return isinstance(v, list) and any(_has_host(e) for e in v)


def _on_device(v, device):
    """``v`` with its numeric numpy arrays as tensors on ``device``."""
    if isinstance(v, np.ndarray) and v.dtype != object:
        from bigdl_tpu_torch.ops.tf_ops import as_tensor
        return as_tensor(v, device)
    if isinstance(v, list):
        return [_on_device(e, device) for e in v]
    return v
