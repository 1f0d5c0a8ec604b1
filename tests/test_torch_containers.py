"""The port's containers and graphs (``bigdl_tpu_torch/nn/containers.py``,
``nn/graph.py``) against the JAX reference's on the CPU.

Each case is built from the same builder in both packages (the class
names are the reference's), the reference's seeded params are carried into
the port (``convert.module_params_from_jax``), and a seeded input goes
through both. Outputs must agree within 1e-6 (float32 products of a few
terms); the gradients of a seeded weighted sum of the outputs, for every
parameter and for the input, within 1e-5. A Table output of the reference
is a list in the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.utils.table import Table, sorted_items
from bigdl_tpu_torch import convert
from bigdl_tpu_torch import nn as tnn

OUT_TOL = 1e-6
GRAD_TOL = 1e-5


class _NS:
    """One package's layers, the port's built on the CPU."""

    def __init__(self, mod, port):
        self.mod, self.port = mod, port

    def __getattr__(self, name):
        cls = getattr(self.mod, name)
        if self.port and name in ("Linear", "SpatialConvolution",
                                  "BatchNormalization"):
            return lambda *a, **k: cls(*a, device="cpu", **k)
        return cls


def _sequential(n):
    return (n.Sequential().add(n.Linear(6, 5)).add(n.Tanh())
            .add(n.Linear(5, 3)).add(n.LogSoftMax()))


def _nested(n):
    inner = n.Sequential().add(n.Linear(6, 4)).add(n.ReLU())
    return n.Sequential().add(inner).add(n.Linear(4, 2))


def _concat(n):
    return n.Concat(1).add(n.Linear(6, 3)).add(
        n.Sequential().add(n.Linear(6, 2)).add(n.Tanh()))


def _concat_table_add(n):
    return n.Sequential().add(
        n.ConcatTable().add(n.Linear(6, 4)).add(n.Linear(6, 4))
    ).add(n.CAddTable())


def _parallel_table(n):
    return (n.Sequential()
            .add(n.ConcatTable().add(n.Identity()).add(n.Tanh()))
            .add(n.ParallelTable().add(n.Linear(6, 2)).add(n.Linear(6, 3)))
            .add(n.JoinTable(1)))


def _map_table(n):
    return (n.Sequential()
            .add(n.ConcatTable().add(n.Identity()).add(n.Sigmoid()))
            .add(n.MapTable(n.Linear(6, 3)))
            .add(n.SelectTable(2)))


def _bottle(n):
    return n.Bottle(n.Sequential().add(n.Linear(6, 3)).add(n.Tanh()), 2, 2)


def _batch_norm(n):
    return (n.Sequential().add(n.Linear(6, 5))
            .add(n.BatchNormalization(5)).add(n.Tanh()))


def _graph_branches(n):
    inp = n.Input()
    a = n.Tanh()(n.Linear(6, 4)(inp))
    b = n.Linear(6, 4)(inp)
    s = n.CAddTable()(a, b)
    return n.Graph(inp, n.Linear(4, 3)(s))


def _graph_two_in_two_out(n):
    i1, i2 = n.Input(), n.Input()
    j = n.JoinTable(1)(n.Linear(6, 2)(i1), n.Linear(3, 2)(i2))
    o1 = n.LogSoftMax()(n.Linear(4, 3)(j))
    o2 = n.Tanh()(j)
    return n.Graph([i1, i2], [o1, o2])


CASES = {
    "sequential": (_sequential, [(4, 6)]),
    "nested_sequential": (_nested, [(4, 6)]),
    "concat": (_concat, [(4, 6)]),
    "concat_table_cadd": (_concat_table_add, [(4, 6)]),
    "parallel_table": (_parallel_table, [(4, 6)]),
    "map_table_shared": (_map_table, [(4, 6)]),
    "bottle": (_bottle, [(2, 4, 6)]),
    "batch_norm_state": (_batch_norm, [(8, 6)]),
    "graph_branches": (_graph_branches, [(4, 6)]),
    "graph_two_in_two_out": (_graph_two_in_two_out, [(4, 6), (4, 3)]),
}


def _leaves(y):
    if isinstance(y, Table):
        return [v for _, v in sorted_items(y)]
    if isinstance(y, (list, tuple)):
        return list(y)
    return [y]


def _graph_list(jm, tree):
    return ([tree[str(nd.id)] for nd in jm.exec_order]
            if isinstance(jm, jnn.Graph) else tree)


def _pair(case):
    build, shapes = CASES[case]
    jm = build(_NS(jnn, False))
    rng = np.random.default_rng(7)
    xs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jx = [jnp.asarray(x) for x in xs] if len(xs) > 1 else jnp.asarray(xs[0])
    spec = jax.tree_util.tree_map(
        lambda v: jax.ShapeDtypeStruct(v.shape, v.dtype), jx)
    params, state = jm.setup(jax.random.PRNGKey(0), spec)
    tm = build(_NS(tnn, True))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    np_state = jax.tree_util.tree_map(np.asarray, state)
    tm.load_state_dict(convert.module_params_from_jax(
        tm, _graph_list(jm, np_params), _graph_list(jm, np_state)))
    return jm, params, state, tm, xs, jx


@pytest.mark.parametrize("case", list(CASES))
def test_forward_and_gradients_match_reference(case):
    jm, params, state, tm, xs, jx = _pair(case)
    tx = [torch.from_numpy(x).requires_grad_() for x in xs]
    tin = tx if len(tx) > 1 else tx[0]
    ty = _leaves(tm(tin))
    jy, new_state = jm.apply(params, state, jx, training=True)
    jy = _leaves(jy)
    assert len(ty) == len(jy)
    for t, j in zip(ty, jy):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   rtol=0, atol=OUT_TOL)

    rng = np.random.default_rng(11)
    weights = [rng.standard_normal(np.shape(j)).astype(np.float32)
               for j in jy]

    def f(p, x):
        y, _ = jm.apply(p, state, x, training=True)
        return sum(jnp.sum(v * w) for v, w in zip(_leaves(y), weights))

    jg_p, jg_x = jax.grad(f, argnums=(0, 1))(params, jx)
    total = sum((t * torch.from_numpy(w)).sum() for t, w in zip(ty, weights))
    total.backward()
    grads = {n: p.grad for n, p in tm.named_parameters()}
    tg_p, _ = convert.module_params_to_jax(tm, grads)
    want = jax.tree_util.tree_leaves(_graph_list(jm, jax.tree_util.tree_map(
        np.asarray, jg_p)))
    got = jax.tree_util.tree_leaves(tg_p)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_TOL)
    for t, j in zip(tx, jax.tree_util.tree_leaves(jg_x)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), rtol=0,
                                   atol=GRAD_TOL)
    # BN running statistics move as the reference's returned state does
    _, tstate = convert.module_params_to_jax(tm)
    for g, w in zip(jax.tree_util.tree_leaves(tstate),
                    jax.tree_util.tree_leaves(_graph_list(
                        jm, jax.tree_util.tree_map(np.asarray, new_state)))):
        np.testing.assert_allclose(g, w, rtol=0, atol=OUT_TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_state_dict_keys_are_list_index_paths(case):
    _, _, _, tm, _, _ = _pair(case)
    for key in tm.state_dict():
        parts = key.split(".")
        assert all(p.isdigit() for p in parts[:-1]), key
    assert set(convert.module_params_from_jax(
        tm, *convert.module_params_to_jax(tm))) == set(tm.state_dict())


def test_map_table_and_bottle_share_one_child():
    m = tnn.MapTable(tnn.Linear(6, 3, device="cpu")).reset(0)
    assert len(m) == 1 and [k for k, _ in m.named_parameters()] == \
        ["0.weight", "0.bias"]
    outs = m([torch.ones(2, 6), torch.ones(2, 6)])
    assert torch.equal(outs[0], outs[1])
    b = tnn.Bottle(tnn.Linear(6, 3, device="cpu")).reset(0)
    assert tuple(b(torch.zeros(2, 5, 6)).shape) == (2, 5, 3)


def test_add_returns_the_container_and_indexing_works():
    s = tnn.Sequential()
    assert s.add(tnn.Tanh()) is s
    s.add(tnn.ReLU())
    assert len(s) == 2 and isinstance(s[1], tnn.ReLU)
    assert [type(m).__name__ for m in s] == ["Tanh", "ReLU"]


def test_graph_refuses_an_unconnected_input_and_orders_as_reference():
    for n in (jnn, tnn):
        i1, i2 = n.Input(), n.Input()
        out = n.Tanh()(i1)
        with pytest.raises(ValueError, match="not connected"):
            n.Graph([i1, i2], out)
    jm = _graph_branches(_NS(jnn, False))
    tm = _graph_branches(_NS(tnn, True))
    assert [type(nd.module).__name__ for nd in jm.exec_order] == \
        [type(nd.module).__name__ for nd in tm.exec_order]
    with pytest.raises(TypeError, match="Nodes"):
        tnn.Tanh().inputs(torch.zeros(1))
