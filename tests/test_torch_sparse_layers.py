"""The port's sparse layers (``bigdl_tpu_torch/nn/sparse.py``:
``dense_to_sparse``, ``DenseToSparse``, ``SparseLinear``,
``SparseJoinTable``) against the reference's (``bigdl_tpu/nn/sparse.py``)
on the CPU, modelled on the reference's ``tests/test_layer_stragglers.py``.

- Each case is one of a parametrised test: the same seeded COO batch (or
  dense input) and the reference's weights (the (in, out) layout both
  packages keep), forward, the values' and the dense input's gradients
  and the weight and bias gradients within 1e-5 of the reference's largest
  magnitude (float32: ``index_add`` and ``segment_sum`` add a row's terms
  in other orders; on the card ``index_add``'s atomics vary that order
  from run to run, so the port is never held bit for bit).
- ``dense_to_sparse`` gives the reference's indices and values exactly,
  on the input's device; ``SparseJoinTable`` the reference's triple.
- ``SparseLinear`` of a COO batch equals it of the dense batch, and trains
  (the reference's straggler test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.utils.table import T
from bigdl_tpu_torch import convert
from bigdl_tpu_torch import nn as tnn

CPU = "cpu"
REL = 1e-5


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=REL * scale,
                               err_msg=what)


def _coo(n, width, per_row, seed, repeat=False):
    """A seeded (n, width) COO batch with ``per_row`` entries a row (with
    ``repeat``, some (row, column) pairs twice: they add)."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), per_row)
    cols = np.concatenate([rng.choice(width, per_row, replace=repeat)
                           for _ in range(n)])
    idx = np.stack([rows, cols], 1).astype(np.int32)
    vals = rng.standard_normal(len(rows)).astype(np.float32)
    return idx, vals, (n, width)


# name -> (n, in, out, entries a row, with_bias, repeated pairs)
LINEAR = {
    "small": (6, 10, 4, 3, True, False),
    "no_bias": (5, 12, 3, 4, False, False),
    "repeated_pairs": (4, 8, 5, 6, True, True),
    "wide": (16, 1000, 32, 8, True, False),
}


@pytest.mark.parametrize("name", sorted(LINEAR))
def test_sparse_linear_matches_the_reference(name):
    n, d_in, d_out, per_row, bias, repeat = LINEAR[name]
    idx, vals, shape = _coo(n, d_in, per_row, seed=len(name), repeat=repeat)
    ref = jnn.SparseLinear(d_in, d_out, with_bias=bias)
    ref.build(3, (n, d_in))
    params = jax.tree_util.tree_map(np.asarray, ref.params)
    port = tnn.SparseLinear(d_in, d_out, with_bias=bias, device=CPU)
    port.load_state_dict(convert.module_params_from_jax(port, params))
    np.testing.assert_array_equal(port.weight.detach().numpy(),
                                  params["weight"])

    def jf(p, v):
        return ref.apply(p, (), jnn.SparseTensor(idx, v, shape))[0]

    y_ref, vjp = jax.vjp(jf, ref.params, jnp.asarray(vals))
    cot = np.random.default_rng(9).standard_normal(y_ref.shape) \
        .astype(np.float32)
    gp_ref, gv_ref = vjp(jnp.asarray(cot))
    v = torch.tensor(vals, requires_grad=True)
    y = port(tnn.SparseTensor(torch.from_numpy(idx), v, shape))
    _close(y.detach().numpy(), np.asarray(y_ref), f"{name} forward")
    grads = torch.autograd.grad(y, [v] + list(port.parameters()),
                                torch.from_numpy(cot))
    _close(grads[0].numpy(), np.asarray(gv_ref), f"{name} value gradient")
    for (k, _), g in zip(port.named_parameters(), grads[1:]):
        _close(g.numpy(), np.asarray(gp_ref[k]), f"{name} gradient of {k}")
    # the dense batch through the dense path gives the same
    dense = np.zeros(shape, np.float32)
    np.add.at(dense, (idx[:, 0], idx[:, 1]), vals)
    y_dense = port(torch.from_numpy(dense))
    _close(y_dense.detach().numpy(), np.asarray(
        ref.apply(ref.params, (), jnp.asarray(dense))[0]), f"{name} dense")
    _close(y_dense.detach().numpy(), y.detach().numpy(), f"{name} coo")


@pytest.mark.parametrize("device_arg", ["numpy", "tensor"])
def test_dense_to_sparse_gives_the_reference_triple(device_arg):
    rs = np.random.RandomState(3)
    dense = rs.randn(6, 10).astype(np.float32)
    dense[rs.rand(6, 10) < 0.7] = 0.0
    want = jnn.dense_to_sparse(dense)
    x = dense if device_arg == "numpy" else torch.from_numpy(dense)
    for got in (tnn.dense_to_sparse(x), tnn.DenseToSparse()(x)):
        assert got.dense_shape == want.dense_shape
        assert got.indices.dtype == torch.int32
        assert got.values.device.type == "cpu"
        np.testing.assert_array_equal(got.indices.numpy(),
                                      np.asarray(want.indices))
        np.testing.assert_array_equal(got.values.numpy(),
                                      np.asarray(want.values))
        np.testing.assert_array_equal(got.to_dense().numpy(), dense)


@pytest.mark.parametrize("dim", [0, 1])
def test_sparse_join_table_matches_the_reference(dim):
    a = _coo(3, 4, 2, seed=1)
    b = _coo(3 if dim == 1 else 2, 5 if dim == 1 else 4, 2, seed=2)
    want = jnn.SparseJoinTable(dim).build(0).forward(
        T(jnn.SparseTensor(*a), jnn.SparseTensor(*b)))
    got = tnn.SparseJoinTable(dim)([tnn.SparseTensor(*a),
                                    tnn.SparseTensor(*b)])
    assert got.dense_shape == want.dense_shape
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    np.testing.assert_array_equal(got.values.numpy(),
                                  np.asarray(want.values))


def test_sparse_linear_trains():
    """The reference straggler test's fit: 60 SGD steps on a sparse batch
    lower the MSE, from the same weights as the reference's, and each
    step's loss stays within 1e-5 of the reference's."""
    rs = np.random.RandomState(4)
    dense = ((rs.rand(32, 8) < 0.3) * rs.randn(32, 8)).astype(np.float32)
    ys = dense @ rs.randn(8, 1).astype(np.float32)
    ref = jnn.SparseLinear(8, 1)
    ref.build(5, (32, 8))
    sp = jnn.dense_to_sparse(dense)
    crit = jnn.MSECriterion()
    p_ref = ref.params
    port = tnn.SparseLinear(8, 1, device=CPU)
    port.load_state_dict(convert.module_params_from_jax(
        port, jax.tree_util.tree_map(np.asarray, p_ref)))
    tsp = tnn.dense_to_sparse(dense)
    tcrit = tnn.MSECriterion()
    y_t = torch.from_numpy(ys)
    losses = []
    for _ in range(60):
        l_ref, g = jax.value_and_grad(
            lambda p: crit.apply(ref.apply(p, (), sp)[0],
                                 jnp.asarray(ys)))(p_ref)
        p_ref = jax.tree_util.tree_map(lambda w, d: w - 0.1 * d, p_ref, g)
        loss = tcrit(port(tsp), y_t)
        grads = torch.autograd.grad(loss, list(port.parameters()))
        with torch.no_grad():
            for w, d in zip(port.parameters(), grads):
                w.sub_(0.1 * d)
        loss = float(loss.detach())
        np.testing.assert_allclose(loss, float(l_ref), rtol=1e-5)
        losses.append(loss)
    assert losses[-1] < 0.2 * losses[0]
