"""The port's Inception models (``bigdl_tpu_torch/models/inception.py``)
against the JAX reference's (``bigdl_tpu/models/inception.py``) on the
CPU, at 224 x 224.

Both packages build the same tree of ``Sequential`` and ``Concat``; the
reference's seeded params (and BN state) are carried into the port by
``convert.module_params_from_jax``. Bars (float32 on both sides):
log-probabilities within 1e-4; the loss within 1e-5 relative; BN running
statistics at rtol 1e-4 / atol 1e-5. Dropout is off, or the model
evaluates (the reference's draws are ``jax.random``'s).

Gradients (and an SGD step's updates, -lr x the gradients): each within
1e-4 of its largest magnitude, or within NOISE_FACTOR times the
reference's own float32 noise floor where that is larger. The floor is
how far the reference's gradient moves when the images move by 2^-23
relative (the larger of two draws). At their initial weights on random
images these models' gradients are not smooth in the input: a 2^-23
change moves Inception-v1's first convolution's weight gradient by 0.4 %
of its largest magnitude (its max pools' near-ties and ReLU kinks), so a
fixed 1e-4 bar cannot hold whatever the port computes.

NOISE_FACTOR is 10, as ``chip_smoke.py`` holds ResNet-50's card-vs-CPU
gradients: two draws of the floor underestimate it on some leaves, and
another library's summation order moves a gradient as an input change
does.

Inception-v2's step is held by its loss, its BN statistics and its
classifier's update; its other gradients are not held. In training mode,
with 51 BN layers over a batch of 2, its float32 gradients are mostly
rounding: measured at batch 8 against a float64 run of the port (its
convolutions through ``F.conv2d`` in float64), the reference's float32
gradients are up to 38 times their largest magnitude away, the port's up
to 11 times. In evaluation mode a ReLU whose input lies within float32
rounding of 0 takes either side in either library: at this batch the
port's float32 gradient of inception 4c's 5x5 weight is 0.9 % of its
largest magnitude from both the reference's and the port's own float64
run, which agree to 7e-7; no bar over whole leaves separates that from a
fault.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.models import inception as jinc
from bigdl_tpu.nn.criterion import ClassNLLCriterion as JaxNLL
from bigdl_tpu.optim import methods as jmethods
from bigdl_tpu.optim.optimizer import make_train_step as jax_train_step
from bigdl_tpu_torch import convert, optim
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.models import (Inception_v1,
                                    Inception_v1_NoAuxClassifier,
                                    Inception_v2)

LOGP_ATOL = 1e-4
LOSS_REL = 1e-5
GRAD_REL = 1e-4
STATE_TOL = dict(rtol=1e-4, atol=1e-5)
NOISE_FACTOR = 10
CLASSES = 20
HW = 224
LR = 0.05


def _pair(jm, tm, shape, seed=0):
    params, state = jm.setup(jax.random.PRNGKey(seed),
                             jax.ShapeDtypeStruct(shape, jnp.float32))
    tm.load_state_dict(convert.module_params_from_jax(
        tm, jax.tree_util.tree_map(np.asarray, params),
        jax.tree_util.tree_map(np.asarray, state)))
    return params, state


def _batch(n, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 3, HW, HW)).astype(np.float32),
            rng.integers(0, CLASSES, n).astype(np.int32))


def _leaves(tree):
    return jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray,
                                                            tree))


def _ref_grads(jm, params, state, x, y, training, scale=1.0):
    """``scale`` x the reference's gradients at ``x`` and at two 2^-23
    relative moves of it (leaves)."""
    def at(images):
        def f(p):
            out, _ = jm.apply(p, state, jnp.asarray(images),
                              training=training)
            return JaxNLL().apply(out, jnp.asarray(y))
        return [scale * g for g in _leaves(jax.grad(f)(params))]

    moved = []
    for seed in (0, 1):
        move = np.random.default_rng(seed).random(x.shape)
        moved.append(at(x * (1 + (move.astype(np.float32) - 0.5)
                             * 2.0 ** -22)))
    return at(x), moved


def _close_grads(got, want, moved):
    """Each leaf of ``got`` within the larger of GRAD_REL x max|want| and
    NOISE_FACTOR times how far ``want`` moves in ``moved``."""
    got = _leaves(got)
    assert len(got) == len(want) > 0
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape
        noise = max(np.abs(m[i] - w).max() for m in moved)
        bar = max(GRAD_REL * np.abs(w).max(), NOISE_FACTOR * noise)
        assert np.abs(g - w).max() <= bar, (i, np.abs(g - w).max(), bar)


def _port_grads(tm):
    return convert.module_params_to_jax(
        tm, {k: p.grad for k, p in tm.named_parameters()})[0]


def test_inception_v1_aux_forward_matches_reference():
    """Both auxiliary heads at batch 1 (the reference test's shape), in
    evaluation: (1, 3 x classes), each head's slice a log-softmax."""
    x, _ = _batch(1)
    jm = jinc.Inception_v1(CLASSES)
    tm = Inception_v1(CLASSES, device="cpu")
    params, state = _pair(jm, tm, x.shape)
    want, _ = jm.apply(params, state, jnp.asarray(x), training=False)
    with torch.no_grad():
        got = tm.evaluate()(torch.from_numpy(x).contiguous(
            memory_format=torch.channels_last))
    assert tuple(got.shape) == (1, 3 * CLASSES)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LOGP_ATOL)
    for s in range(3):
        torch.testing.assert_close(
            got[:, s * CLASSES:(s + 1) * CLASSES].exp().sum(1),
            torch.ones(1), rtol=1e-5, atol=0)


def test_inception_v1_aux_loss_and_gradients_match_reference():
    """Training mode without dropout at batch 2; ``ClassNLLCriterion``'s
    targets index the main head's slice, as the reference trains it."""
    x, y = _batch(2, seed=2)
    jm = jinc.Inception_v1(CLASSES, has_dropout=False)
    tm = Inception_v1(CLASSES, has_dropout=False, device="cpu")
    params, state = _pair(jm, tm, x.shape)

    def loss_fn(p):
        out, _ = jm.apply(p, state, jnp.asarray(x), training=True)
        return JaxNLL().apply(out, jnp.asarray(y))

    jloss = loss_fn(params)
    jgrads, moved = _ref_grads(jm, params, state, x, y, training=True)
    loss = tnn.ClassNLLCriterion()(tm.train()(torch.from_numpy(x)),
                                   torch.from_numpy(y).long())
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= LOSS_REL * abs(float(jloss))
    _close_grads(_port_grads(tm), jgrads, moved)
    # the aux heads' weights train: the criterion reads the main slice
    # only, so their gradients are zero on both sides
    aux = [p.grad for k, p in tm.named_parameters()
           if k.startswith("1.1.")]
    assert aux and all(float(g.abs().max()) == 0.0 for g in aux)


@pytest.mark.parametrize("name", ["Inception_v1_NoAuxClassifier",
                                  "Inception_v2"])
def test_inception_forward_and_step_match_reference(name):
    """Evaluation forward at batch 1, then one SGD step at batch 2 in
    training mode (dropout off): loss, updates (Inception-v2: the
    classifier's) and BN statistics."""
    v2 = name == "Inception_v2"
    kw = {} if v2 else {"has_dropout": False}
    make = {"Inception_v1_NoAuxClassifier": Inception_v1_NoAuxClassifier,
               "Inception_v2": Inception_v2}[name]
    jm = getattr(jinc, name)(CLASSES, **kw)
    x1, _ = _batch(1, seed=3)
    tm = make(CLASSES, device="cpu", **kw)
    params, state = _pair(jm, tm, x1.shape)
    want, _ = jm.apply(params, state, jnp.asarray(x1), training=False)
    with torch.no_grad():
        got = tm.evaluate()(torch.from_numpy(x1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LOGP_ATOL)

    x, y = _batch(2, seed=4)
    method = jmethods.SGD(learningrate=LR)
    step = jax_train_step(jm, JaxNLL(), method)
    want_p, want_s, _, want_loss = step(
        *jax.tree_util.tree_map(jnp.array, (params, state)),
        method.init_state(params), jax.random.PRNGKey(1), jnp.asarray(x),
        jnp.asarray(y))
    tmethod = optim.SGD(learningrate=LR)
    tstep = optim.make_train_step(tm, tnn.ClassNLLCriterion(), tmethod)
    got_loss = tstep(tmethod.init_state(dict(tm.named_parameters())),
                     torch.from_numpy(x), torch.from_numpy(y).long())
    assert abs(float(got_loss) - float(want_loss)) \
        <= LOSS_REL * abs(float(want_loss))
    got_p, got_s = convert.module_params_to_jax(tm)
    before = _leaves(params)
    got_up = [g - b for g, b in zip(_leaves(got_p), before)]
    want_up = [w - b for w, b in zip(_leaves(want_p), before)]
    if v2:
        # the classifier's weight and bias, the last two leaves
        for g, w in zip(got_up[-2:], want_up[-2:]):
            assert np.abs(g - w).max() <= GRAD_REL * np.abs(w).max()
    else:
        _, moved = _ref_grads(jm, params, state, x, y, training=True,
                              scale=-LR)
        _close_grads(got_up, want_up, moved)
    got_s = jax.tree_util.tree_leaves(got_s)
    want_s = jax.tree_util.tree_leaves(want_s)
    assert len(got_s) == len(want_s) == (2 * (3 + 8 * 6) if v2 else 0)
    for g, w in zip(got_s, want_s):
        np.testing.assert_allclose(g, np.asarray(w), **STATE_TOL)


def test_aux_pooling_gives_4x4_on_14x14():
    pool = tnn.SpatialAveragePooling(5, 5, 3, 3, ceil_mode=True)
    assert pool.output_hw(14, 14) == (4, 4)
    assert tuple(pool(torch.zeros(1, 2, 14, 14)).shape) == (1, 2, 4, 4)
