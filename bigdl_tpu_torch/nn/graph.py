"""DAG models (the port of ``bigdl_tpu/nn/graph.py``: ``Node``, ``Input``,
``Graph``).

A graph is wired with the reference's node calls: ``x = layer(node)``.
``Graph(inputs, outputs)`` orders the nodes reachable from the outputs
by the reference's reverse depth-first walk, raises on a cycle and on an
input that reaches no output, and registers each node's module under its
place in that order, so a ``state_dict`` key is ``"<i>.<leaf>"``
(``convert.module_params_from_jax`` maps the reference's node-id keys by
the same order). A node fed by several nodes receives the list of their
outputs, in wiring order; several graph inputs take a list or tuple; a
graph with several outputs returns a list. ``forward`` hands its
``generator`` to every node's module whose ``forward`` takes one.
"""

from __future__ import annotations

from bigdl_tpu_torch.nn.basic import Input as InputModule
from bigdl_tpu_torch.nn.module import Module, Node, call_with_generator

__all__ = ["Graph", "Input", "Node"]


def Input():
    """A graph input placeholder node (reference ``nn/Input.scala``)."""
    return Node(InputModule())


class Graph(Module):
    """Static DAG module (reference ``nn/Graph.scala:72``)."""

    def __init__(self, inputs, outputs):
        super().__init__()
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
                raise ValueError(
                    f"graph node {node.module.get_name()} has no inputs and "
                    "is not a graph input")
            if len(self.input_nodes) > 1:
                return list(graph_input)[self.input_nodes.index(node)]
            return graph_input
        if len(node.prev_nodes) == 1:
            return values[node.prev_nodes[0].id]
        return [values[p.id] for p in node.prev_nodes]

    def forward(self, x, generator=None):
        values = {}
        for node in self.exec_order:
            values[node.id] = call_with_generator(
                node.module, self._gather_input(node, values, x), generator)
        if len(self.output_nodes) == 1:
            return values[self.output_nodes[0].id]
        return [values[n.id] for n in self.output_nodes]
