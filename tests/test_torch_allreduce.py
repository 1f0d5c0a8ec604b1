"""The port's ZeRO-1 collectives and data-parallel step
(``bigdl_tpu_torch/parallel/allreduce.py``) against the reference's
(``bigdl_tpu/parallel/allreduce.py``), on the CPU.

The reference runs on the 8-device virtual CPU mesh of
``tests/conftest.py``; the port on ``mesh=["cpu"] * N``, one thread
driving N replicas. Both start from the reference's seeded weights
(``convert.module_params_from_jax``) and see the same numpy batches.

Bars:
- the collectives alone, on the same per-replica vectors: bit-equal at
  N = 2 (one rounding of a two-term sum in the wire type); within one ulp
  of the wire type at N = 4 and 8 (the reference's reduction order inside
  ``psum_scatter`` is XLA's);
- one step at float32 wire: rtol 2e-5 / atol 2e-6, the reference test's
  own bar (``tests/test_distributed.py:104``: the same float32 math in
  two libraries' orders); at bfloat16 wire 1e-3 x max|w| (one bfloat16
  rounding of a gradient slice can land on either side in the two
  orders); BN statistics within 1e-6;
- the ZeRO-1 layout at init: replica p's master slice bit-equal to the
  reference's device-p shard.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import bigdl_tpu.nn as jnn
import bigdl_tpu.optim as jopt
from bigdl_tpu.parallel.allreduce import (
    AllReduceParameter as JaxARP, make_distributed_train_step as jax_step)
from bigdl_tpu.utils.jax_compat import shard_map
from bigdl_tpu_torch import convert
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch import optim as topt
from bigdl_tpu_torch.parallel import allreduce as tar

WIRE = {"bfloat16": (jnp.bfloat16, torch.bfloat16),
        "float32": (jnp.float32, torch.float32)}


def _mesh(n):
    devs = np.asarray(jax.devices()[:n])
    assert devs.size == n, "conftest should provide 8 CPU devices"
    return Mesh(devs, axis_names=("data",))


def _models(bn=False, seed=0):
    """The reference's test model (``tests/test_distributed.py:30``), or
    with a BatchNormalization after the first Linear, and its port with
    the same weights."""
    def build(pkg, **kw):
        m = pkg.Sequential().add(pkg.Linear(4, 16, **kw))
        if bn:
            m.add(pkg.BatchNormalization(16, **kw))
        return (m.add(pkg.ReLU()).add(pkg.Linear(16, 3, **kw))
                .add(pkg.LogSoftMax()))

    jm = build(jnn).build(seed, (2, 4))
    tm = build(tnn, device="cpu")
    tm.load_state_dict(convert.module_params_from_jax(
        tm, jax.tree_util.tree_map(np.asarray, jm.params),
        jax.tree_util.tree_map(np.asarray, jm.state)))
    return jm, tm


def _batch(n=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 4)).astype(np.float32)
    y = (np.abs(x).argmax(axis=1) % 3).astype(np.int32)
    return x, y


def _ulp(x, dtype):
    """One unit in the last place of each of ``x`` in ``dtype``."""
    bits = 8 if dtype == "bfloat16" else 24
    return np.maximum(np.abs(x), np.finfo(np.float32).tiny) \
        * 2.0 ** (1 - bits)


# ------------------------------------------------------- the collectives --
@pytest.mark.parametrize("wire", ["bfloat16", "float32"])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_reduce_scatter_matches_psum_scatter(n, wire):
    """Replica p's mean slice from the same per-replica flat gradients."""
    jw, tw = WIRE[wire]
    size = 40 * n
    g = np.random.default_rng(n).standard_normal((n, size)).astype(
        np.float32)

    def rs(local):
        s = lax.psum_scatter(local[0].astype(jw), "data",
                             scatter_dimension=0, tiled=True)
        return s.astype(jnp.float32) / n

    want = np.asarray(shard_map(rs, mesh=_mesh(n), in_specs=P("data"),
                                out_specs=P("data"), check_vma=False)(
        jnp.asarray(g)))
    got = np.concatenate([s.numpy() for s in tar.reduce_scatter(
        [torch.from_numpy(r) for r in g], [torch.device("cpu")] * n, tw)])
    if n == 2:
        np.testing.assert_array_equal(got, want)
    else:
        assert np.all(np.abs(got - want) <= _ulp(want * n, wire) / n), \
            np.abs(got - want).max()


@pytest.mark.parametrize("wire", ["bfloat16", "float32"])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_all_gather_matches_reference(n, wire):
    """Every replica's gathered vector: the wire-rounded slices, in
    replica order, as new tensors (no replica aliases another's)."""
    jw, tw = WIRE[wire]
    w = np.random.default_rng(10 + n).standard_normal(24 * n).astype(
        np.float32)

    def ag(local):
        return lax.all_gather(local.astype(jw), "data",
                              tiled=True).astype(jnp.float32)

    want = np.asarray(shard_map(ag, mesh=_mesh(n), in_specs=P("data"),
                                out_specs=P(), check_vma=False)(
        jnp.asarray(w)))
    slices = list(torch.from_numpy(w).chunk(n))
    fulls = tar.all_gather(slices, [torch.device("cpu")] * n, tw)
    assert len({f.data_ptr() for f in fulls}) == n
    for f in fulls:
        np.testing.assert_array_equal(f.numpy(), want)


def test_ring_allreduce_bytes_matches_reference():
    from bigdl_tpu.parallel.allreduce import ring_allreduce_bytes
    for n_elems, ndev in ((1000, 2), (25_557_032, 2), (999, 8)):
        for jd, td in ((jnp.bfloat16, torch.bfloat16),
                       (jnp.float32, torch.float32)):
            assert tar.ring_allreduce_bytes(n_elems, ndev, td) == \
                ring_allreduce_bytes(n_elems, ndev, jd)


# ------------------------------------------------------- flat layout --
@pytest.mark.parametrize("n", [2, 3, 8])
def test_flat_order_and_padding_match_ravel_pytree(n):
    """The flat vector is the reference's ``ravel_pytree`` of its params,
    padded to a multiple of N; ``to_params`` and ``load_into`` invert
    it."""
    jm, tm = _models(bn=True)
    jarp = JaxARP(jm.params, n)
    arp = tar.AllReduceParameter(dict(tm.named_parameters()), n)
    assert (arp.total_size, arp.padded_size, arp.slice_size) == (
        jarp.total_size, jarp.padded_size, jarp.slice_size)
    np.testing.assert_array_equal(arp.flat().numpy(), np.asarray(jarp.flat()))
    back = arp.to_params(arp.flat())
    for name, p in tm.named_parameters():
        assert torch.equal(back[name], p.detach())
    zeros = {k: torch.zeros_like(v) for k, v in back.items()}
    arp.load_into(arp.flat(), zeros)
    for name, p in tm.named_parameters():
        assert torch.equal(zeros[name], p.detach())


def test_flat_order_of_a_convolution_graph():
    """LeNet-5's convolution (HWIO) and Linear ((in, out)) weights land in
    the reference's order and layout."""
    from bigdl_tpu.models.lenet import LeNet5 as JaxLeNet5
    from bigdl_tpu_torch.models.lenet import LeNet5
    jm = JaxLeNet5(10).build(1, (2, 1, 28, 28))
    tm = LeNet5(10, device="cpu")
    tm.load_state_dict(convert.module_params_from_jax(
        tm, jax.tree_util.tree_map(np.asarray, jm.params)))
    arp = tar.AllReduceParameter(dict(tm.named_parameters()), 2)
    np.testing.assert_array_equal(arp.flat().numpy(),
                                  np.asarray(JaxARP(jm.params, 2).flat()))


# ------------------------------------------------------- one step --
def _jax_step(jm, method, n, wire, x, y, clipping=None, accumulate=1):
    factory = jax_step(jm, jnn.ClassNLLCriterion(), method, _mesh(n),
                       wire_dtype=WIRE[wire][0], clipping=clipping,
                       accumulate_steps=accumulate)
    step_fn, flat, opt_shard = factory(jm.params)
    sh = NamedSharding(_mesh(n), P("data"))
    new_flat, state, opt_shard, loss = step_fn(
        flat, jm.state, opt_shard, jax.random.key(0),
        jax.device_put(x, sh), jax.device_put(y, sh))
    return np.asarray(new_flat), state, opt_shard, float(loss)


def _torch_step(tm, method, n, wire, x, y, clipping=None, accumulate=1):
    step = tar.make_distributed_train_step(
        tm, tnn.ClassNLLCriterion(), method, ["cpu"] * n,
        clipping=clipping, wire_dtype=WIRE[wire][1],
        accumulate_steps=accumulate)
    loss = step(torch.from_numpy(x), torch.from_numpy(y).long())
    return step, float(loss)


def _check_masters(step, want, wire):
    got = step.state.full_master(torch.device("cpu")).numpy()
    if wire == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)
    else:
        assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max()


METHODS = {"sgd": (lambda: jopt.SGD(learningrate=0.1, momentum=0.9),
                   lambda: topt.SGD(learningrate=0.1, momentum=0.9)),
           "adam": (lambda: jopt.Adam(learningrate=0.01),
                    lambda: topt.Adam(learningrate=0.01))}


@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
@pytest.mark.parametrize("method", ["sgd", "adam"])
@pytest.mark.parametrize("n", [2, 4])
def test_one_step_matches_reference(n, method, wire):
    jm, tm = _models()
    x, y = _batch(32)
    want, _, _, jloss = _jax_step(jm, METHODS[method][0](), n, wire, x, y)
    step, loss = _torch_step(tm, METHODS[method][1](), n, wire, x, y)
    _check_masters(step, want, wire)
    assert abs(loss - jloss) <= 1e-5 * abs(jloss)


@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [2, 4])
def test_batchnorm_statistics_match_reference(n, wire):
    """BN running statistics: each replica's from its rows, averaged in
    replica order (the reference's ``pmean``)."""
    jm, tm = _models(bn=True)
    x, y = _batch(32, seed=1)
    want, jstate, _, _ = _jax_step(jm, jopt.SGD(learningrate=0.1), n, wire,
                                   x, y)
    step, _ = _torch_step(tm, topt.SGD(learningrate=0.1), n, wire, x, y)
    _check_masters(step, want, wire)
    bn = step.state.replicas[0][1]
    for leaf in ("running_mean", "running_var"):
        np.testing.assert_allclose(getattr(bn, leaf).numpy(),
                                   np.asarray(jstate[1][leaf]), atol=1e-6)
    for r in step.state.replicas[1:]:
        assert torch.equal(r[1].running_mean, bn.running_mean)


@pytest.mark.parametrize("case", ["accumulate", "freeze", "constant_clip",
                                  "l2_clip"])
def test_step_options_match_reference(case):
    """accumulate_steps=2, a frozen first layer, and both clippings, at
    N = 2 and float32 wire."""
    jm, tm = _models()
    x, y = _batch(32, seed=2)
    kw = {}
    if case == "accumulate":
        kw = dict(accumulate=2)
    elif case == "freeze":
        jm[0].freeze()
        tm[0].freeze()
    elif case == "constant_clip":
        kw = dict(clipping=("constant", -0.01, 0.01))
    else:
        kw = dict(clipping=("l2norm", 0.05))
    want, _, _, _ = _jax_step(jm, jopt.SGD(learningrate=0.5), 2, "float32",
                              x, y, **kw)
    step, _ = _torch_step(tm, topt.SGD(learningrate=0.5), 2, "float32", x,
                          y, **kw)
    _check_masters(step, want, "float32")


# ------------------------------------------------------- ZeRO-1 layout --
@pytest.mark.parametrize("method", ["sgd", "adam"])
@pytest.mark.parametrize("n", [2, 4])
def test_zero1_layout_matches_reference_shards(n, method):
    """Replica p holds the reference's device-p shard: its master slice
    (bit-equal at init, within the step bar after one step) and each slot
    of its optimizer state (``padded_size / N`` elements), all on its own
    device and in memory no other replica shares."""
    jm, tm = _models()
    x, y = _batch(32, seed=3)
    jmethod, tmethod = METHODS[method][0](), METHODS[method][1]()
    factory = jax_step(jm, jnn.ClassNLLCriterion(), jmethod, _mesh(n),
                       wire_dtype=jnp.float32)
    _, flat0, _ = factory(jm.params)
    step = tar.make_distributed_train_step(
        tm, tnn.ClassNLLCriterion(), tmethod, ["cpu"] * n,
        wire_dtype=torch.float32)
    st = step.state
    shards = sorted(flat0.addressable_shards, key=lambda s: s.index[0].start)
    for p, sh in enumerate(shards):
        np.testing.assert_array_equal(st.masters[p].numpy(),
                                      np.asarray(sh.data))
    _, _, jopt_shard, _ = _jax_step(jm, METHODS[method][0](), n, "float32",
                                    x, y)
    step(torch.from_numpy(x), torch.from_numpy(y).long())
    slots = ("velocity",) if method == "sgd" else ("m", "v")
    for slot in slots:
        jshards = sorted(jopt_shard[slot].addressable_shards,
                         key=lambda s: s.index[0].start)
        for p, sh in enumerate(jshards):
            mine = st.opt_states[p][slot]["flat"]
            assert mine.shape == (st.arp.padded_size // n,)
            assert mine.device == st.devices[p]
            np.testing.assert_allclose(mine.numpy(), np.asarray(sh.data),
                                       rtol=2e-5, atol=2e-6)
    ptrs = [m.data_ptr() for m in st.masters] + [
        s[slots[0]]["flat"].data_ptr() for s in st.opt_states]
    assert len(set(ptrs)) == len(ptrs)
    assert int(st.opt_states[n - 1]["step"]) == 1


def test_master_weights_stay_float32_precise():
    """Updates far below a bfloat16 ulp accumulate in the float32 masters
    (the reference's ``test_master_weights_stay_f32_precise``)."""
    tm = tnn.Sequential().add(tnn.Linear(4, 4, with_bias=False,
                                         device="cpu"))
    tm.reset(0)
    def mse(out, y):
        return torch.mean(torch.square(out - y))

    step = tar.make_distributed_train_step(
        tm, mse, topt.SGD(learningrate=1e-4), ["cpu"] * 2)
    w0 = step.state.full_master(torch.device("cpu")).clone()
    x, y = torch.ones(8, 4), torch.zeros(8, 4)
    for _ in range(50):
        step(x, y)
    w1 = step.state.full_master(torch.device("cpu"))
    assert (w1 - w0).abs().max() > 1e-4
