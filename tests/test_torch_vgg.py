"""The port's VGG models (``bigdl_tpu_torch/models/vgg.py``) against the
JAX reference's (``bigdl_tpu/models/vgg.py``) on the CPU.

Both packages build the same ``Sequential``; the reference's seeded params
and BN state are carried into the port by ``convert.module_params_from_
jax``. The reference's convolutions are ``lax.conv``; the port's 3x3
stride-1 convolutions run the kernels' plain versions on the CPU.

Bars (float32 on both sides): log-probabilities within 1e-4; the loss
within 1e-5 relative; each gradient within 1e-4 of its largest magnitude,
or within NOISE_FACTOR times the reference's own float32 noise floor where
that is larger; after one SGD step, the weights' updates held as the
gradients are and BN running statistics at rtol 1e-4 / atol 1e-5. Dropout
is off: the reference's draws are ``jax.random``'s
(``tests/test_torch_cnn_layers.py`` holds the port's by statistics).

The noise floor is how far the reference's gradient moves when the images
move by 2^-23 relative (the larger of two such draws). VggForCifar10 at
batch 4 is ill-conditioned at its initial weights: 13 training-mode BN
layers, the last three over 16 values a channel. Such a change moves its
weight gradients by 4e-5 to 4e-2 of their largest magnitudes, and a
convolution's bias before a BN has an exact gradient of 0, so both
packages return rounding noise there. A fixed 1e-4 bar sits at or below
that floor whatever the port computes. NOISE_FACTOR is 10, as
``chip_smoke.py`` holds ResNet-50's card-vs-CPU gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.models import vgg as jvgg
from bigdl_tpu.nn.criterion import ClassNLLCriterion as JaxNLL
from bigdl_tpu.optim import methods as jmethods
from bigdl_tpu.optim.optimizer import make_train_step as jax_train_step
from bigdl_tpu_torch import convert, optim
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.models import Vgg_16, Vgg_19, VggForCifar10

LOGP_ATOL = 1e-4
LOSS_REL = 1e-5
GRAD_REL = 1e-4
STATE_TOL = dict(rtol=1e-4, atol=1e-5)
NOISE_FACTOR = 10


def _pair(jm, tm, shape, seed=0):
    """The reference's seeded params and state for ``shape`` inputs,
    loaded into ``tm``."""
    params, state = jm.setup(jax.random.PRNGKey(seed),
                             jax.ShapeDtypeStruct(shape, jnp.float32))
    tm.load_state_dict(convert.module_params_from_jax(
        tm, jax.tree_util.tree_map(np.asarray, params),
        jax.tree_util.tree_map(np.asarray, state)))
    return params, state


def _batch(shape, classes, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.integers(0, classes, shape[0]).astype(np.int32))


def _perturbed(x, seed):
    move = np.random.default_rng(seed).random(x.shape).astype(np.float32)
    return x * (1 + (move - 0.5) * 2.0 ** -22)


def _close_grads(got, want, moved):
    """``got`` within the larger of GRAD_REL x max|want| and NOISE_FACTOR
    times how far ``want`` moves under the perturbed images (``moved``,
    the reference's gradients there)."""
    got = jax.tree_util.tree_leaves(got)
    want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray,
                                                            want))
    moved = [jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray,
                                                              m))
             for m in moved]
    assert len(got) == len(want) > 0
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape
        noise = max(np.abs(m[i] - w).max() for m in moved)
        bar = max(GRAD_REL * np.abs(w).max(), NOISE_FACTOR * noise)
        assert np.abs(g - w).max() <= bar, (i, np.abs(g - w).max(), bar)


def test_vgg_cifar10_step_matches_reference():
    """VggForCifar10 without dropout, batch 4 at 32 x 32: log-probabilities,
    loss and gradients of a training forward, then one SGD step's weights
    and BN running statistics."""
    x, y = _batch((4, 3, 32, 32), 10)
    jm = jvgg.VggForCifar10(10, has_dropout=False)
    tm = VggForCifar10(10, has_dropout=False, device="cpu")
    params, state = _pair(jm, tm, x.shape)
    jx = jnp.asarray(x)

    def loss_fn(p):
        out, new_state = jm.apply(p, state, jx, training=True)
        return JaxNLL().apply(out, jnp.asarray(y)), (out, new_state)

    (jloss, (jout, _)), jgrads = jax.value_and_grad(
        loss_fn, has_aux=True)(params)

    def grads_at(images):
        def f(p):
            out, _ = jm.apply(p, state, jnp.asarray(images), training=True)
            return JaxNLL().apply(out, jnp.asarray(y))
        return jax.grad(f)(params)

    moved = [grads_at(_perturbed(x, seed)) for seed in (0, 1)]
    tm.train()
    out = tm(torch.from_numpy(x))
    loss = tnn.ClassNLLCriterion()(out, torch.from_numpy(y).long())
    loss.backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=0, atol=LOGP_ATOL)
    assert abs(loss.item() - float(jloss)) <= LOSS_REL * abs(float(jloss))
    tg, _ = convert.module_params_to_jax(
        tm, {k: p.grad for k, p in tm.named_parameters()})
    _close_grads(tg, jgrads, moved)

    # one SGD step through each package's make_train_step
    method = jmethods.SGD(learningrate=0.05)
    step = jax_train_step(jm, JaxNLL(), method)
    want_p, want_s, _, want_loss = step(
        *jax.tree_util.tree_map(jnp.array, (params, state)),
        method.init_state(params), jax.random.PRNGKey(1), jx, jnp.asarray(y))
    tm2 = VggForCifar10(10, has_dropout=False, device="cpu")
    _pair(jm, tm2, x.shape)
    tmethod = optim.SGD(learningrate=0.05)
    tstep = optim.make_train_step(tm2, tnn.ClassNLLCriterion(), tmethod)
    got_loss = tstep(tmethod.init_state(dict(tm2.named_parameters())),
                     torch.from_numpy(x), torch.from_numpy(y).long())
    assert abs(float(got_loss) - float(want_loss)) \
        <= LOSS_REL * abs(float(want_loss))
    # the step's updates, -lr x the gradients: held as the gradients are
    got_p, got_s = convert.module_params_to_jax(tm2)
    before = jax.tree_util.tree_map(np.asarray, params)
    _close_grads(
        jax.tree_util.tree_map(np.subtract, got_p, before),
        jax.tree_util.tree_map(lambda a, b: np.asarray(a) - b, want_p,
                               before),
        [jax.tree_util.tree_map(lambda g: -0.05 * np.asarray(g), m)
         for m in moved])
    got_s = jax.tree_util.tree_leaves(got_s)
    want_s = jax.tree_util.tree_leaves(want_s)
    assert len(got_s) == len(want_s) == 28      # 14 BN layers x 2
    for g, w in zip(got_s, want_s):
        np.testing.assert_allclose(g, np.asarray(w), **STATE_TOL)


def test_vgg16_forward_matches_reference():
    """VGG-16 at 224 x 224, batch 1, evaluation mode."""
    x, _ = _batch((1, 3, 224, 224), 1000, seed=2)
    jm = jvgg.Vgg_16(1000)
    tm = Vgg_16(1000, device="cpu")
    params, state = _pair(jm, tm, x.shape)
    want, _ = jm.apply(params, state, jnp.asarray(x), training=False)
    with torch.no_grad():
        got = tm.evaluate()(torch.from_numpy(x).contiguous(
            memory_format=torch.channels_last))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LOGP_ATOL)


def _layers(m):
    return [type(c).__name__ for c in m]


@pytest.mark.parametrize("name", ["Vgg_16", "Vgg_19"])
def test_vgg_structure_matches_reference(name):
    jm = getattr(jvgg, name)(1000)
    tm = {"Vgg_16": Vgg_16, "Vgg_19": Vgg_19}[name](1000, device="cpu")
    assert _layers(tm) == [type(c).__name__ for c in jm.modules]
    for j, t in zip(jm.modules, tm):
        if type(j).__name__ == "SpatialConvolution":
            assert (t.n_input_plane, t.n_output_plane, t.kernel_h,
                    t.stride_h, t.pad_h) == (j.n_input_plane,
                                             j.n_output_plane, j.kernel_h,
                                             j.stride_h, j.pad_h)
        if type(j).__name__ == "Dropout":
            assert t.p == j.p
    n_params = sum(p.numel() for p in tm.parameters())
    assert n_params == {"Vgg_16": 138_357_544, "Vgg_19": 143_667_240}[name]
    x = torch.zeros(1, 3, 224, 224)
    hw = (224, 224)
    for m in tm:
        if hasattr(m, "output_hw"):
            hw = m.output_hw(*hw)
    assert hw == (7, 7)
    assert tuple(tm[0].weight.shape) == (64, 3, 3, 3) and x.shape[1] == 3


def test_vgg_dropout_draws_only_with_a_generator():
    tm = VggForCifar10(10, device="cpu").train()
    drops = [m for m in tm if isinstance(m, tnn.Dropout)]
    assert [m.p for m in drops] == [0.3] + [0.4] * 7 + [0.5]
    x = torch.from_numpy(_batch((2, 3, 32, 32), 10)[0])

    def run(seed):
        with torch.no_grad():
            return tm(x, generator=torch.Generator().manual_seed(seed))

    torch.testing.assert_close(run(0), run(0), rtol=0, atol=0)
    assert not torch.allclose(run(0), run(1))
    with torch.no_grad():
        assert torch.isfinite(tm(x)).all()
