"""The port's GPT training path (``bigdl_tpu_torch/models/gpt.py``
forward, ``nn/criterion.py``, ``optim/``) against the JAX reference on the
same weights.

A tiny GPT (vocab 97, hidden 32, 2 layers, 2 heads, max_position 128) on
a batch of 2 x 128 tokens. Every reference layer runs its Pallas flash
kernel (interpret mode on the CPU): ``use_flash = True`` on each layer, as
``bench.py`` sets it, and T = 128 meets the kernel's 128-multiple rule, so
the reference does not fall back to ``full_attention``. The port's
wrappers run their plain versions on the CPU. Logits, loss, gradients and
updated weights agree at rtol 1e-4 (float32 on both sides; atol 1e-6 for
values near zero, such as LayerNorm-bias gradients).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.models.gpt import GPTForCausalLM as JaxGPT
from bigdl_tpu.nn.criterion import ClassNLLCriterion as JaxNLL
from bigdl_tpu.nn.criterion import CrossEntropyCriterion as JaxCE
from bigdl_tpu.optim import methods as jmethods
from bigdl_tpu.optim.optimizer import clip_by_global_norm as jax_clip_norm
from bigdl_tpu.optim.optimizer import clip_by_value as jax_clip_value
from bigdl_tpu.optim.optimizer import make_train_step as jax_train_step
from bigdl_tpu.parallel import sequence as jax_sequence
from bigdl_tpu_torch import convert, optim
from bigdl_tpu_torch.models.gpt import GPTForCausalLM
from bigdl_tpu_torch.nn import ClassNLLCriterion, CrossEntropyCriterion

CFG = dict(vocab_size=97, hidden_size=32, n_layers=2, n_heads=2,
           max_position=128)
B, T = 2, 128
TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def ref():
    """The reference model with its flash kernel on, its params tree
    (numpy) and a seeded batch: inputs (B, T) and flattened labels."""
    jm = JaxGPT(**CFG)
    for lyr in jm.gpt.layers:
        lyr.attn.use_flash = True
    params, _ = jm.setup(jax.random.PRNGKey(0), None)
    tree = jax.tree_util.tree_map(np.asarray, params)
    ids = np.random.RandomState(0).randint(0, 97, (B, T + 1)).astype(
        np.int32)
    return jm, tree, ids[:, :-1], ids[:, 1:].reshape(-1)


def _port(tree, **kw):
    tm = GPTForCausalLM(**CFG, device="cpu", **kw)
    tm.load_state_dict(convert.params_from_jax(tree))
    return tm


def _torch(a):
    return torch.from_numpy(np.asarray(a)).long()


def _assert_tree_close(got, want, **tol):
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    flat_w = jax.tree_util.tree_leaves(want)
    assert len(flat_g) == len(flat_w)
    for (path, g), w in zip(flat_g, flat_w):
        np.testing.assert_allclose(g, np.asarray(w), err_msg=str(path),
                                   **tol)


def _jax_train(jm, tree, method, x, y, steps, **kw):
    step = jax_train_step(jm, JaxCE(), method, **kw)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    opt_state = method.init_state(params)
    state, losses = (), []
    for _ in range(steps):
        params, state, opt_state, loss = step(
            params, state, opt_state, jax.random.PRNGKey(1), jnp.asarray(x),
            jnp.asarray(y))
        losses.append(float(loss))
    return params, losses


def _port_train(tree, method, x, y, steps, **kw):
    tm = _port(tree)
    step = optim.make_train_step(tm, CrossEntropyCriterion(), method, **kw)
    opt_state = method.init_state(dict(tm.named_parameters()))
    losses = [float(step(opt_state, _torch(x), _torch(y)))
              for _ in range(steps)]
    return tm, opt_state, losses


def test_logits_loss_and_grads_match_reference(ref, monkeypatch):
    jm, tree, x, y = ref

    def no_fallback(*a, **kw):
        raise AssertionError("the reference left its flash kernel")

    # the reference must reach its Pallas kernel, not the XLA oracle
    monkeypatch.setattr(jax_sequence, "full_attention", no_fallback)

    def loss_fn(p):
        logits, _ = jm.apply(p, (), jnp.asarray(x), training=True)
        return JaxCE().apply(logits, jnp.asarray(y)), logits

    (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, tree))
    tm = _port(tree)
    got_logits = tm(_torch(x))
    assert got_logits.shape == (B * T, 97)
    got_loss = CrossEntropyCriterion()(got_logits, _torch(y))
    got_loss.backward()
    np.testing.assert_allclose(got_logits.detach().numpy(),
                               np.asarray(logits), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(got_loss.detach()), float(loss),
                               rtol=1e-4)
    want = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, grads))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   err_msg=name, **TOL)


def test_sgd_momentum_steps_match_reference(ref):
    jm, tree, x, y = ref
    kw = dict(learningrate=0.1, momentum=0.9)
    want_params, want_losses = _jax_train(jm, tree, jmethods.SGD(**kw), x,
                                          y, 3)
    tm, opt_state, losses = _port_train(tree, optim.SGD(**kw), x, y, 3)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-4)
    assert int(opt_state["step"]) == 3
    _assert_tree_close(convert.params_to_jax(tm.state_dict()),
                       want_params, rtol=1e-4, atol=1e-5)


def test_adam_losses_match_reference(ref):
    jm, tree, x, y = ref
    _, want = _jax_train(jm, tree, jmethods.Adam(learningrate=1e-2), x, y, 3)
    _, _, got = _port_train(tree, optim.Adam(learningrate=1e-2), x, y, 3)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[2] < got[0]


def test_accumulate_steps_match_reference(ref):
    jm, tree, x, y = ref
    want_params, want_losses = _jax_train(
        jm, tree, jmethods.SGD(learningrate=0.1), x, y, 1,
        accumulate_steps=2)
    tm, _, losses = _port_train(tree, optim.SGD(learningrate=0.1), x, y, 1,
                                accumulate_steps=2)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-4)
    _assert_tree_close(convert.params_to_jax(tm.state_dict()),
                       want_params, rtol=1e-4, atol=1e-5)


METHODS = {
    "sgd_nesterov": dict(cls="SGD", learningrate=0.1, momentum=0.9,
                         dampening=0.0, nesterov=True),
    "sgd_decay_l2": dict(cls="SGD", learningrate=0.1, weightdecay=0.01,
                         learningrate_decay=0.5),
    "adam": dict(cls="Adam", learningrate=1e-2, beta1=0.8),
    "adamw": dict(cls="AdamW", learningrate=1e-2, weightdecay=0.1),
}


@pytest.mark.parametrize("name", list(METHODS))
def test_update_matches_reference_on_given_grads(name):
    """Two updates on given numpy gradients, parameter by parameter: the
    weights and every slot agree with the reference's."""
    kw = dict(METHODS[name])
    cls = kw.pop("cls")
    rs = np.random.RandomState(1)
    params = {n: rs.randn(*s).astype(np.float32)
              for n, s in (("w", (4, 3)), ("b", (3,)))}
    grads = [{n: rs.randn(*a.shape).astype(np.float32)
              for n, a in params.items()} for _ in range(2)]
    jm = getattr(jmethods, cls)(**kw)
    tm = getattr(optim, cls)(**kw)
    jp = {n: jnp.asarray(a) for n, a in params.items()}
    jstate = jm.init_state(jp)
    tp = {n: torch.from_numpy(a.copy()) for n, a in params.items()}
    tstate = tm.init_state(tp)
    for g in grads:
        jp, jstate = jm.update({n: jnp.asarray(a) for n, a in g.items()},
                               jstate, jp)
        tm.update({n: torch.from_numpy(a) for n, a in g.items()}, tstate,
                  tp)
    for n in params:
        np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]),
                                   rtol=1e-6, atol=1e-7)
    for slot in ("velocity", "m", "v"):
        assert (slot in tstate) == (slot in jstate)
        for n in tstate.get(slot, {}):
            np.testing.assert_allclose(tstate[slot][n].numpy(),
                                       np.asarray(jstate[slot][n]),
                                       rtol=1e-6, atol=1e-7)
    assert int(tstate["step"]) == int(jstate["step"]) == 2
    np.testing.assert_allclose(float(tm.current_lr(tstate)),
                               float(jm.current_lr(jstate)), rtol=1e-7)


def test_clipping_matches_reference():
    rs = np.random.RandomState(2)
    grads = {n: rs.randn(*s).astype(np.float32)
             for n, s in (("a", (5, 4)), ("b", (7,)))}
    tg = {n: torch.from_numpy(a) for n, a in grads.items()}
    for max_norm in (0.5, 1e3):       # scales down; leaves alone
        want = jax_clip_norm(grads, max_norm)
        got = optim.clip_by_global_norm(tg, max_norm)
        for n in grads:
            np.testing.assert_allclose(got[n].numpy(), np.asarray(want[n]),
                                       rtol=1e-6)
    want = jax_clip_value(grads, -0.3, 0.2)
    got = optim.clip_by_value(tg, -0.3, 0.2)
    for n in grads:
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]))


def test_clipping_inside_the_train_step(ref):
    jm, tree, x, y = ref
    kw = dict(learningrate=0.1)
    want_params, _ = _jax_train(
        jm, tree, jmethods.SGD(**kw), x, y, 1,
        clipping=lambda g: jax_clip_norm(g, 0.05))
    tm, _, _ = _port_train(
        tree, optim.SGD(**kw), x, y, 1,
        clipping=lambda g: optim.clip_by_global_norm(g, 0.05))
    _assert_tree_close(convert.params_to_jax(tm.state_dict()),
                       want_params, rtol=1e-4, atol=1e-6)


def test_criterion_weights_and_padding_match_reference():
    rs = np.random.RandomState(3)
    logits = rs.randn(6, 5).astype(np.float32)
    target = np.array([0, 3, -1, 4, -1, 2], np.int32)
    weights = np.array([0.5, 1.0, 2.0, 1.5, 0.2], np.float32)
    cases = [(CrossEntropyCriterion(weights), JaxCE(weights)),
             (CrossEntropyCriterion(size_average=False),
              JaxCE(size_average=False)),
             (ClassNLLCriterion(weights), JaxNLL(weights))]
    for port, jref in cases:
        got = port(torch.from_numpy(logits), torch.from_numpy(target))
        want = jref.apply(jnp.asarray(logits), jnp.asarray(target))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    # an all-padding batch gives 0, not the NaN of a 0/0 mean
    pad = torch.full((6,), -1)
    assert float(CrossEntropyCriterion()(torch.from_numpy(logits), pad)) == 0


def test_remat_matches_no_remat(ref):
    """Per-block remat (the model's flag) and whole-forward remat (the
    train step's) give the loss and gradients of the plain run."""
    _, tree, x, y = ref
    results = []
    for model_remat, step_remat in ((False, False), (True, False),
                                    (False, True)):
        tm = _port(tree, remat=model_remat)
        fn = optim.make_loss_and_grads(tm, CrossEntropyCriterion(),
                                       remat=step_remat)
        loss, grads = fn(_torch(x), _torch(y))
        results.append((float(loss), {n: g.clone() for n, g in
                                      grads.items()}))
    for loss, grads in results[1:]:
        assert loss == pytest.approx(results[0][0], rel=1e-6)
        for n, g in grads.items():
            torch.testing.assert_close(g, results[0][1][n], rtol=1e-5,
                                       atol=1e-7)


def test_remat_replays_the_dropout_draws(ref):
    """With dropout, the recomputation in backward draws the forward's
    masks again from the caller's generator, and leaves the generator
    where the plain run leaves it."""
    _, tree, x, y = ref
    results = []
    for remat in (False, True):
        tm = _port(tree, dropout=0.1, remat=remat)
        gen = torch.Generator().manual_seed(5)
        fn = optim.make_loss_and_grads(tm, CrossEntropyCriterion())
        loss, grads = fn(_torch(x), _torch(y), gen)
        results.append((float(loss), grads, torch.rand(3, generator=gen)))
    (loss0, grads0, next0), (loss1, grads1, next1) = results
    assert loss1 == pytest.approx(loss0, rel=1e-6)
    torch.testing.assert_close(next1, next0, rtol=0, atol=0)
    for n, g in grads1.items():
        torch.testing.assert_close(g, grads0[n], rtol=1e-5, atol=1e-7)


def test_bfloat16_compute_gives_float32_grads(ref):
    _, tree, x, y = ref
    tm = _port(tree)
    f32 = optim.make_loss_and_grads(tm, CrossEntropyCriterion())
    bf16 = optim.make_loss_and_grads(tm, CrossEntropyCriterion(),
                                     compute_dtype=torch.bfloat16)
    loss32, _ = f32(_torch(x), _torch(y))
    loss16, grads = bf16(_torch(x), _torch(y))
    assert all(g.dtype == torch.float32 for g in grads.values())
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    assert torch.isfinite(loss16)
    assert float(loss16) == pytest.approx(float(loss32), rel=0.02)


def test_dropout_draws_from_the_generator(ref):
    _, tree, x, _ = ref
    tm = _port(tree, dropout=0.1)
    ids = _torch(x)

    def run(seed):
        return tm(ids, generator=torch.Generator().manual_seed(seed))

    with torch.no_grad():
        plain = _port(tree)(ids)
        torch.testing.assert_close(run(0), run(0), rtol=0, atol=0)
        assert not torch.equal(run(0), run(1))
        assert not torch.allclose(run(0), plain)
        torch.testing.assert_close(tm(ids), plain, rtol=0, atol=0)
        tm.eval()
        torch.testing.assert_close(run(0), plain, rtol=0, atol=0)
    # the keep rate is 1 - p within 3 sigma; kept values scale by 1/(1-p)
    block = tm.gpt.layers[0].train()
    n, p = 200_000, 0.1
    h = block._drop(torch.ones(n), torch.Generator().manual_seed(2))
    kept = h != 0
    sigma = (p * (1 - p) / n) ** 0.5
    assert abs(float(kept.float().mean()) - (1 - p)) < 3 * sigma
    torch.testing.assert_close(h[kept], torch.full_like(h[kept], 1 / 0.9))


def test_sequence_longer_than_max_position_raises(ref):
    _, tree, _, _ = ref
    with pytest.raises(ValueError, match="max_position"):
        _port(tree)(torch.zeros(1, 129, dtype=torch.long))


def test_params_to_jax_round_trips_exactly(ref):
    _, tree, _, _ = ref
    back = convert.params_to_jax(convert.params_from_jax(tree))
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(tree))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
