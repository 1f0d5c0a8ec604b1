"""The port's LeNet-5 (``bigdl_tpu_torch/models/lenet.py``, both builders)
against the JAX reference's on the CPU, through the container converter
both ways (``convert.module_params_from_jax`` / ``module_params_to_jax``).

The log-probabilities of a seeded batch agree within 2e-5 and the
gradients of the NLL loss within 2e-5: float32 5x5 convolutions over a
few hundred products in two libraries' orders. The converter must be
exact both ways.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.models.lenet import LeNet5 as JaxLeNet5
from bigdl_tpu.models.lenet import lenet_graph as jax_lenet_graph
from bigdl_tpu.nn import ClassNLLCriterion as JaxNLL
from bigdl_tpu_torch import convert
from bigdl_tpu_torch.models import LeNet5, lenet_graph
from bigdl_tpu_torch.nn import ClassNLLCriterion

TOL = 2e-5
BUILDERS = {"sequential": (JaxLeNet5, LeNet5),
            "graph": (jax_lenet_graph, lenet_graph)}


def _order(jm, tree):
    return ([tree[str(n.id)] for n in jm.exec_order]
            if hasattr(jm, "exec_order") else tree)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(n=6, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 1, 28, 28)).astype(np.float32),
            rng.integers(0, 10, n).astype(np.int32))


@pytest.mark.parametrize("builder", list(BUILDERS))
def test_forward_and_gradients_match_reference(builder):
    jb, tb = BUILDERS[builder]
    x, y = _batch()
    jm = jb(10).build(0, (6, 1, 28, 28))
    tm = tb(10, device="cpu")
    tm.load_state_dict(convert.module_params_from_jax(
        tm, _order(jm, _np(jm.params)), _order(jm, _np(jm.state))))

    def loss(p):
        out, _ = jm.apply(p, jm.state, jnp.asarray(x), training=True)
        return JaxNLL().apply(out, jnp.asarray(y)), out

    (jl, jout), jg = jax.value_and_grad(loss, has_aux=True)(jm.params)
    tout = tm(torch.from_numpy(x))
    tl = ClassNLLCriterion()(tout, torch.from_numpy(y))
    tl.backward()
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               rtol=0, atol=TOL)
    assert abs(float(tl.detach()) - float(jl)) <= TOL
    got, _ = convert.module_params_to_jax(
        tm, {n: p.grad for n, p in tm.named_parameters()})
    want = _order(jm, _np(jg))
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL)


@pytest.mark.parametrize("builder", list(BUILDERS))
def test_converter_is_exact_both_ways(builder):
    jb, tb = BUILDERS[builder]
    jm = jb(10).build(3, (2, 1, 28, 28))
    ref = _order(jm, _np(jm.params))
    tm = tb(10, device="cpu")
    sd = convert.module_params_from_jax(tm, ref)
    back, _ = convert.module_params_to_jax(tm, sd)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(ref)):
        np.testing.assert_array_equal(a, b)
    # the port's own seeded weights into the reference: same outputs
    tm = tb(10, device="cpu", seed=5)
    params, state = convert.module_params_to_jax(tm)
    if hasattr(jm, "exec_order"):
        params = {str(n.id): p for n, p in zip(jm.exec_order, params)}
        state = {str(n.id): s for n, s in zip(jm.exec_order, state)}
    x, _ = _batch(3, seed=1)
    want, _ = jm.apply(jax.tree_util.tree_map(jnp.asarray, params), state,
                       jnp.asarray(x))
    got = tm(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=TOL)
    assert set(convert.module_params_from_jax(tm, *convert.
                                              module_params_to_jax(tm))) \
        == set(tm.state_dict())


def test_layer_names_and_seeded_init():
    jm = JaxLeNet5(10)
    tm = LeNet5(10, device="cpu")
    assert [m.get_name() for m in jm.modules] == \
        [m.get_name() for m in tm]
    again = LeNet5(10, device="cpu")
    for (k, a), b in zip(tm.state_dict().items(),
                         again.state_dict().values()):
        assert torch.equal(a, b), k
    other = LeNet5(10, device="cpu", seed=2)
    assert not torch.equal(other[1].weight, tm[1].weight)
    # the reference's initializers' bounds: Xavier for the 5x5 conv
    # (fan 25 + 150), +-1/sqrt(in) for the first Linear
    assert float(tm[1].weight.detach().abs().max()) <= np.sqrt(6 / 175)
    assert float(tm[8].weight.detach().abs().max()) <= 1 / np.sqrt(192)
    assert not torch.any(tm[1].bias)
