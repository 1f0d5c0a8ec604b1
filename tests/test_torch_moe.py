"""The port's mixture-of-experts layer (``bigdl_tpu_torch/nn/moe.py``)
against the reference's (``bigdl_tpu/nn/moe.py``) on the CPU, modelled on
the reference's ``tests/test_pipeline_moe.py``.

- Dense: the port's ``MoE`` and the JAX ``MoE`` on the same seeded tokens
  and weights (``convert.module_params_from_jax``) at capacity factors
  8.0 (nothing dropped) and 0.25 (drops), top-1 and top-2: the outputs,
  the aux loss and the gradients of ``wg``, ``w1``, ``w2`` and the input
  under ``sum(y^2) + 1e-2 * aux``, within 1e-5 of the reference's largest
  magnitude (outputs, aux) or 1e-4 (gradients: float32 products of width
  32 summed in other orders through two GELU layers).
- Expert-parallel: the port over ``["cpu"] * 4`` (two experts a shard,
  each shard's tokens routed at its own capacity) against the reference's
  ``expert_parallel=("expert", 4)`` under ``shard_map`` on a 4-device CPU
  mesh (``tests/conftest.py``'s virtual devices), at both factors: the
  outputs, each shard's aux loss and the gradients as above; at factor
  8.0 also the dense layer's outputs, within the reference test's bar
  (rtol 2e-4, atol 1e-5). Shards of unequal token counts are refused.
- Routing: the port's decisions (expert, position, kept) equal the
  one-hot ``dispatch`` the reference's ``_topk_dispatch`` builds, ties
  going to the first expert; a replayed routing gives the same output.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import bigdl_tpu.nn as jnn
from bigdl_tpu.nn.moe import _topk_dispatch
from bigdl_tpu.utils.jax_compat import shard_map
from bigdl_tpu_torch import convert
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.nn.moe import topk_route

CPU = "cpu"
D, H, E = 16, 32, 8
AUX_W = 1e-2


def _close(got, want, what, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                               err_msg=what)


def _tokens(seed=0, shape=(4, 16, D)):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _ref(k, factor, ndev=None):
    m = jnn.MoE(D, H, E, k=k, capacity_factor=factor,
                expert_parallel=None if ndev is None else ("expert", ndev))
    m.build(0, (4, 16, D))
    return m


def _port(ref_params, k, factor, mesh=None):
    m = tnn.MoE(D, H, E, k=k, capacity_factor=factor,
                expert_parallel=None if mesh is None else ("expert", mesh),
                device=CPU)
    m.load_state_dict(convert.module_params_from_jax(
        m, jax.tree_util.tree_map(np.asarray, ref_params)))
    return m


def _port_grads(m, xs):
    """``(outputs, aux, grads of wg/w1/w2, input grads)`` under
    ``sum(y^2) + AUX_W * sum(aux)``."""
    ts = [torch.tensor(x, requires_grad=True) for x in xs]
    ys = m(ts) if m.expert_parallel is not None else [m(ts[0])]
    aux = m.state["aux_loss"]
    auxes = aux if isinstance(aux, list) else [aux]
    loss = sum((y ** 2).sum() for y in ys) + AUX_W * sum(auxes)
    params = [m.wg, m.w1, m.w2]
    grads = torch.autograd.grad(loss, params + ts)
    return ([y.detach().numpy() for y in ys],
            [float(a.detach()) for a in auxes],
            {k: g.numpy() for k, g in zip(("wg", "w1", "w2"), grads[:3])},
            [g.numpy() for g in grads[3:]])


@pytest.mark.parametrize("factor", [8.0, 0.25])
@pytest.mark.parametrize("k", [1, 2])
def test_dense_moe_matches_the_reference(k, factor):
    ref = _ref(k, factor)
    x = _tokens()

    def loss(p, v):
        y, st = ref.apply(p, (), v)
        return jnp.sum(y ** 2) + AUX_W * st["aux_loss"], (y, st["aux_loss"])

    (_, (y_ref, aux_ref)), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(ref.params, jnp.asarray(x))
    m = _port(ref.params, k, factor)
    ys, auxes, grads, gxs = _port_grads(m, [x])
    _close(ys[0], y_ref, "output", 1e-5)
    np.testing.assert_allclose(auxes[0], float(aux_ref), rtol=1e-5)
    for name in ("wg", "w1", "w2"):
        _close(grads[name], gp[name], f"gradient of {name}", 1e-4)
    _close(gxs[0], gx, "input gradient", 1e-4)
    rows = np.abs(ys[0].reshape(-1, D)).sum(-1)
    if factor < 1:          # over-capacity tokens give zero rows
        assert (rows == 0).any() and (rows > 0).any()
    else:
        assert (rows > 0).all()


@pytest.mark.parametrize("factor", [8.0, 0.25])
def test_expert_parallel_matches_the_reference(factor):
    k, ndev = 2, 4
    mesh = Mesh(np.asarray(jax.devices()[:ndev]), ("expert",))
    ref = _ref(k, factor)
    mp = _ref(k, factor, ndev)
    x = _tokens(seed=1).reshape(-1, D)

    def ep(params, xloc):
        y, st = mp.apply(params, (), xloc)
        return y, st["aux_loss"][None]

    f = shard_map(ep, mesh=mesh, in_specs=(mp.param_specs(), P("expert")),
                  out_specs=(P("expert"), P("expert")), check_vma=False)

    def loss(p, v):
        y, aux = f(p, v)
        return jnp.sum(y ** 2) + AUX_W * jnp.sum(aux), (y, aux)

    (_, (y_ref, aux_ref)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(ref.params, jnp.asarray(x))
    m = _port(ref.params, k, factor, [CPU] * ndev)
    shards = np.split(x, ndev)
    ys, auxes, grads, gxs = _port_grads(m, shards)
    _close(np.concatenate(ys), y_ref, "output", 1e-5)
    np.testing.assert_allclose(auxes, np.asarray(aux_ref), rtol=1e-5)
    for name in ("wg", "w1", "w2"):
        _close(grads[name], gp[name], f"gradient of {name}", 1e-4)
    _close(np.concatenate(gxs), gx, "input gradient", 1e-4)
    if factor >= 8.0:
        dense = _port(ref.params, k, factor)
        with torch.no_grad():
            want = dense(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(np.concatenate(ys), want, rtol=2e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("k,factor", [(1, 1.25), (2, 0.5), (3, 0.25)])
def test_routing_equals_the_reference_dispatch(k, factor):
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((40, E)).astype(np.float32)
    logits[::5] = 0.0                     # rows of equal probabilities
    probs = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    cap = int(np.ceil(k * 40 * factor / E))
    dispatch, _ = _topk_dispatch(jnp.asarray(probs), k, cap)
    want = np.asarray(dispatch)
    got = np.zeros_like(want)
    for idx, pos, keep in topk_route(torch.from_numpy(probs), k, cap):
        for n in np.nonzero(keep.numpy())[0]:
            got[n, int(idx[n]), int(pos[n])] += 1.0
    np.testing.assert_array_equal(got, want)
    # ties go to the first expert, as jnp.argmax
    first = topk_route(torch.from_numpy(probs), k, cap)[0][0].numpy()
    assert (first[::5] == 0).all()


def test_expert_parallel_refuses_shards_of_unequal_size():
    # the reference's shard_map splits one batch evenly; shards of other
    # sizes would have other capacities, and their rows would misalign
    ref = _ref(1, 1.25)
    m = _port(ref.params, 1, 1.25, [CPU] * 4)
    x = _tokens(seed=3).reshape(-1, D)
    shards = [torch.from_numpy(s) for s in (x[:16], x[16:32], x[32:48],
                                            x[48:60])]
    with pytest.raises(ValueError, match=r"\[16, 16, 16, 12\]"):
        m(shards)


def test_a_replayed_routing_gives_the_same_output():
    ref = _ref(2, 0.5)
    m = _port(ref.params, 2, 0.5)
    x = torch.from_numpy(_tokens(seed=2))
    with torch.no_grad():
        y = m(x)
        _, decisions = m.route(x.reshape(-1, D))
        np.testing.assert_array_equal(m(x, decisions=decisions).numpy(),
                                      y.numpy())


def test_moe_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tnn.MoE(D, H, E)
    with pytest.raises(ValueError, match="outside"):
        tnn.MoE(D, H, E, k=9, device=CPU)
