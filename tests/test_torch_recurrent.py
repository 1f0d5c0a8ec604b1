"""The port's recurrent layers, embeddings and ``TimeDistributedCriterion``
(``bigdl_tpu_torch/nn/recurrent.py``, ``embedding.py``, ``criterion.py``,
``models/rnn.py``) against the JAX reference's on the CPU.

Each case builds the same layer in both packages; the reference's params,
every leaf redrawn from a seeded normal (so zero-initialised biases and
peepholes are exercised), are carried into the port
(``convert.module_params_from_jax``) and a seeded input goes through
both. Bars: outputs within 1e-5 absolute (float32 over a few steps of a
loop); the gradients of a seeded weighted sum of the outputs, for every
parameter and for a float input, within 1e-4 of each leaf's largest
reference magnitude (``jax.grad`` against autograd). Dropout draws differ
between the packages, so parity is held at ``p = 0`` and an active
dropout is checked as the reference's own test does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.models.rnn import PTBModel as JPTBModel
from bigdl_tpu.optim.regularizer import L2Regularizer as JL2
from bigdl_tpu_torch import convert
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.models import PTBModel, SimpleRNN
from bigdl_tpu_torch.optim import L2Regularizer
from bigdl_tpu_torch.nn.module import regularization_loss

OUT_TOL = 1e-5
GRAD_REL = 1e-4


def _redraw(tree, seed, scale=0.3):
    """Every float leaf of a reference params tree redrawn, seeded."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (scale * rng.standard_normal(np.shape(a))).astype(
            np.float32), tree)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(jm, tm, shape, seed=0, ids=None):
    """(reference params, its state, port module) with the port loaded
    from the redrawn reference params."""
    spec = (jax.ShapeDtypeStruct(shape, jnp.int32) if ids else shape)
    jm.build(seed, spec)
    params = _redraw(jm.params, seed + 100)
    tm.load_state_dict(convert.module_params_from_jax(
        tm, params, _np(jm.state)), strict=True)
    return params, _np(jm.state), tm


def _hold_grads(got, want):
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        w = np.asarray(w)
        np.testing.assert_allclose(
            g, w, rtol=0, atol=GRAD_REL * max(np.abs(w).max(), 1e-12))


def _parity(jm, tm, shape, seed=0, with_x_grad=True):
    """Forward and gradients of ``sum(y * ct)`` in both packages."""
    params, state, tm = _pair(jm, tm, shape, seed)
    rng = np.random.default_rng(seed + 7)
    x = rng.standard_normal(shape).astype(np.float32)

    def ref_loss(p, xx):
        y, _ = jm.apply(p, state, xx, training=False)
        return jnp.sum(y * ct), y

    y_ref = np.asarray(jm.apply(params, state, jnp.asarray(x),
                                training=False)[0])
    ct = jnp.asarray(rng.standard_normal(y_ref.shape).astype(np.float32))
    (_, _), (gp, gx) = jax.value_and_grad(ref_loss, argnums=(0, 1),
                                          has_aux=True)(params,
                                                        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(with_x_grad)
    y = tm(xt)
    np.testing.assert_allclose(y.detach().numpy(), y_ref, rtol=0,
                               atol=OUT_TOL)
    (y * torch.from_numpy(np.array(ct))).sum().backward()
    grads = {n: p.grad for n, p in tm.named_parameters()}
    got = convert.module_params_to_jax(tm, grads)[0]
    _hold_grads(got, gp)
    if with_x_grad:
        np.testing.assert_allclose(
            xt.grad.numpy(), np.asarray(gx), rtol=0,
            atol=GRAD_REL * max(np.abs(np.asarray(gx)).max(), 1e-12))
    return tm


def _cells(n, port):
    kw = {"device": "cpu"} if port else {}
    return {"rnn": lambda: n.RnnCell(5, 7, **kw),
            "lstm": lambda: n.LSTM(5, 7, **kw),
            "lstm_peephole": lambda: n.LSTMPeephole(5, 7, **kw),
            "gru": lambda: n.GRU(5, 7, **kw)}


@pytest.mark.parametrize("cell", ["rnn", "lstm", "lstm_peephole", "gru"])
def test_recurrent_cell_matches_reference(cell):
    _parity(jnn.Recurrent(_cells(jnn, False)[cell]()),
            tnn.Recurrent(_cells(tnn, True)[cell]()), (3, 6, 5))


@pytest.mark.parametrize("merge,width", [("add", 6), ("concat", 12)])
def test_birecurrent_merges_match_reference(merge, width):
    tm = _parity(jnn.BiRecurrent(merge).add(jnn.LSTM(4, 6)),
                 tnn.BiRecurrent(merge).add(tnn.LSTM(4, 6, device="cpu")),
                 (2, 5, 4))
    assert tm(torch.zeros(2, 5, 4)).shape == (2, 5, width)


def test_recurrent_decoder_matches_reference():
    _parity(jnn.RecurrentDecoder(4, jnn.LSTM(6, 6)),
            tnn.RecurrentDecoder(4, tnn.LSTM(6, 6, device="cpu")), (2, 6))


def test_multi_rnn_cell_matches_reference():
    _parity(jnn.Recurrent(jnn.MultiRNNCell([jnn.LSTM(5, 8),
                                            jnn.GRU(8, 6)])),
            tnn.Recurrent(tnn.MultiRNNCell([tnn.LSTM(5, 8, device="cpu"),
                                            tnn.GRU(8, 6, device="cpu")])),
            (2, 7, 5))


def test_time_distributed_matches_reference():
    _parity(jnn.TimeDistributed(jnn.Linear(4, 9)),
            tnn.TimeDistributed(tnn.Linear(4, 9, device="cpu")), (2, 5, 4))


@pytest.mark.parametrize("stride,kc,peep", [(1, 3, True), (1, 3, False),
                                            (2, 5, True), (2, 3, False)])
def test_conv_lstm_matches_reference(stride, kc, peep):
    _parity(jnn.Recurrent(jnn.ConvLSTMPeephole(2, 4, 3, kc, stride=stride,
                                               with_peephole=peep)),
            tnn.Recurrent(tnn.ConvLSTMPeephole(2, 4, 3, kc, stride=stride,
                                               with_peephole=peep,
                                               device="cpu")),
            (2, 3, 2, 7, 7))


def test_conv_lstm_3x3_convolutions_take_the_kernel_route(monkeypatch):
    """Both 3x3 stride-1 convolutions of a step run on the 3x3 kernels'
    path (their plain versions here): 2 x T forward, an input gradient for
    each whose input needs one (the first hidden state does not)."""
    from bigdl_tpu_torch.ops import conv3x3 as cv
    calls = []
    real = cv._run

    def spy(x, w, flip):
        calls.append(flip)
        return real(x, w, flip)

    monkeypatch.setattr(cv, "_run", spy)
    lib = dict(tnn.SpatialConvolution.library_calls)
    tm = tnn.Recurrent(tnn.ConvLSTMPeephole(3, 4, 3, 3, device="cpu")
                       ).reset(1)
    x = torch.randn(2, 4, 3, 6, 6, requires_grad=True)
    tm(x).sum().backward()
    t = 4
    assert calls.count(False) == 2 * t and calls.count(True) == 2 * t - 1
    assert dict(tnn.SpatialConvolution.library_calls) == lib


def test_conv_lstm_3d_matches_reference():
    _parity(jnn.Recurrent(jnn.ConvLSTMPeephole3D(2, 3)),
            tnn.Recurrent(tnn.ConvLSTMPeephole3D(2, 3, device="cpu")),
            (2, 2, 2, 4, 4, 4))


def test_cell_single_step_call_and_regularizer():
    jm = jnn.LSTM(3, 4, w_regularizer=JL2(1.0), u_regularizer=JL2(0.5))
    tm = tnn.LSTM(3, 4, w_regularizer=L2Regularizer(1.0),
                  u_regularizer=L2Regularizer(0.5), device="cpu")
    jr = jnn.Recurrent(jm).build(0, (2, 5, 3))
    params = _redraw(jr.params, 3)
    tr = tnn.Recurrent(tm)
    tr.load_state_dict(convert.module_params_from_jax(tr, params))
    want = float(jr.regularization_loss(params))
    assert float(regularization_loss(tr).detach()) == pytest.approx(
        want, rel=1e-6)
    x = np.random.default_rng(1).standard_normal((2, 3)).astype(np.float32)
    out, (h, c) = tm([torch.from_numpy(x), None])
    ref = jm.call(params, [jnp.asarray(x), jm.init_hidden(params, 2)])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref[1]),
                               atol=OUT_TOL)


def test_lstm_dropout_active_and_the_identity_at_eval():
    tm = tnn.Recurrent(tnn.LSTM(4, 6, p=0.5, device="cpu")).reset(0)
    x = torch.ones(4, 5, 4)
    tm.train()
    y1 = tm(x, generator=torch.Generator().manual_seed(0))
    y2 = tm(x, generator=torch.Generator().manual_seed(1))
    assert float((y1 - y2).abs().max()) > 1e-6
    tm.eval()
    torch.testing.assert_close(
        tm(x, generator=torch.Generator().manual_seed(0)), tm(x))


# -------------------------------------------------------------- embedding
def _lookup_pair(jm, tm, ids):
    params, _, tm = _pair(jm, tm, ids.shape, ids=True)
    y_ref = np.asarray(jm.apply(params, (), jnp.asarray(ids))[0])
    ct = np.random.default_rng(2).standard_normal(y_ref.shape).astype(
        np.float32)
    g_ref = jax.grad(lambda p: jnp.sum(
        jm.apply(p, (), jnp.asarray(ids))[0] * ct))(params)
    y = tm(torch.from_numpy(ids))
    np.testing.assert_allclose(y.detach().numpy(), y_ref, atol=OUT_TOL)
    (y * torch.from_numpy(ct)).sum().backward()
    _hold_grads(convert.module_params_to_jax(
        tm, {"weight": tm.weight.grad})[0], g_ref)
    return tm, tm.weight.grad


@pytest.mark.parametrize("kw", [{}, {"padding_value": 0},
                                {"max_norm": 1.5},
                                {"padding_value": 3, "max_norm": 0.8}])
def test_lookup_table_matches_reference(kw):
    ids = np.array([[0, 1, 2, 9], [3, 0, 5, 12]], np.int32)   # 12 clips
    _, g = _lookup_pair(jnn.LookupTable(10, 4, **kw),
                        tnn.LookupTable(10, 4, device="cpu", **kw), ids)
    assert float(g[7].abs().sum()) == 0.0       # an untouched row


@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
def test_lookup_table_sparse_combiners_match_reference(combiner):
    ids = np.array([[1, 2, -1], [4, -1, -1]], np.int32)
    weights = np.array([[0.5, 2.0, 1.0], [3.0, 1.0, 1.0]], np.float32)
    jm = jnn.LookupTableSparse(5, 3, combiner=combiner, max_norm=2.0)
    jm.build(0, jax.ShapeDtypeStruct(ids.shape, jnp.int32))
    params = _redraw(jm.params, 5)
    tm = tnn.LookupTableSparse(5, 3, combiner=combiner, max_norm=2.0,
                               device="cpu")
    tm.load_state_dict(convert.module_params_from_jax(tm, params))
    for x in (jnp.asarray(ids), [jnp.asarray(ids), jnp.asarray(weights)]):
        want = np.asarray(jm.apply(params, (), x)[0])
        got = tm([torch.from_numpy(ids), torch.from_numpy(weights)]
                 if isinstance(x, list) else torch.from_numpy(ids))
        np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-6)


def test_time_distributed_criterion_matches_reference():
    from bigdl_tpu.nn import ClassNLLCriterion as JNLL
    from bigdl_tpu.nn import TimeDistributedCriterion as JTD
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 5, 6)).astype(np.float32)
    logp = x - np.log(np.exp(x).sum(-1, keepdims=True))
    y = rng.integers(0, 6, (3, 5)).astype(np.int32)
    for avg in (False, True):
        jc, tc = JTD(JNLL(), size_average=avg), \
            tnn.TimeDistributedCriterion(tnn.ClassNLLCriterion(),
                                         size_average=avg)
        want, g_ref = jax.value_and_grad(jc.apply)(jnp.asarray(logp),
                                                   jnp.asarray(y))
        xt = torch.from_numpy(logp).requires_grad_(True)
        got = tc(xt, torch.from_numpy(y))
        got.backward()
        assert float(got) == pytest.approx(float(want), rel=1e-6)
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_ref),
                                   atol=1e-7)


# ---------------------------------------------------------------- models
def test_ptb_model_loss_and_gradients_match_reference():
    from bigdl_tpu.nn import ClassNLLCriterion as JNLL
    from bigdl_tpu.nn import TimeDistributedCriterion as JTD
    jm = JPTBModel(input_size=50, hidden_size=16, output_size=50,
                   num_layers=2)
    jm.build(0, jax.ShapeDtypeStruct((2, 7), jnp.int32))
    tm = PTBModel(50, 16, 50, device="cpu")
    params = _np(jm.params)
    tm.load_state_dict(convert.module_params_from_jax(tm, params,
                                                      _np(jm.state)))
    rng = np.random.default_rng(6)
    x = rng.integers(0, 50, (2, 7)).astype(np.int32)
    y = rng.integers(0, 50, (2, 7)).astype(np.int32)
    jc = JTD(JNLL(), size_average=True)

    def loss(p):
        return jc.apply(jm.apply(p, jm.state, jnp.asarray(x))[0],
                        jnp.asarray(y))

    want, g_ref = jax.value_and_grad(loss)(params)
    crit = tnn.TimeDistributedCriterion(tnn.ClassNLLCriterion(),
                                        size_average=True)
    got = crit(tm(torch.from_numpy(x)), torch.from_numpy(y))
    got.backward()
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    grads = {n: p.grad for n, p in tm.named_parameters()}
    _hold_grads(convert.module_params_to_jax(tm, grads)[0], g_ref)
    assert SimpleRNN(40, 8, 40, device="cpu").reset(1)(
        torch.from_numpy(x % 40)).shape == (2, 7, 40)
