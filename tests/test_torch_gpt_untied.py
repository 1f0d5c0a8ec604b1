"""The untied LM head (``GPTForCausalLM(tie_embeddings=False)``: a ``head``
Linear without bias, ``bigdl_tpu_torch/models/gpt.py``) against the
reference's on the CPU, with the reference's weights carried across by
``convert.params_from_jax`` (its ``"head"`` tree).

A tiny GPT (vocab 61, hidden 32, 2 layers, 4 heads, max_position 32):
logits within 1e-5 of their largest magnitude (float32 products of 32
and 128 terms in another order); one Adam step's updated weights, the
head's included, at rtol 1e-4 (atol 1e-6 for values near zero); greedy
``generate`` tokens equal. ``convert.params_to_jax`` gives the tree back
whole, ``init_params`` draws the head from the reference's ``Linear``
default (uniform in +-1/sqrt(hidden)), and the tied model keeps no head.

Tensor-parallel serving of the untied head (``ServingEngine(tp=2)`` on
two CPU shards), dense and paged: at a vocabulary of 64 each shard holds
32 of the head's rows (vocab-parallel, as the reference's ``lm_head``
role), at 61 the head stays whole on every shard; the greedy tokens equal
the unsharded port engine's and the reference's tp 2 engine's exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.models.gpt import GPTForCausalLM as JaxGPT
from bigdl_tpu.nn.criterion import CrossEntropyCriterion as JaxCE
from bigdl_tpu.optim import methods as jmethods
from bigdl_tpu.optim.optimizer import make_train_step as jax_train_step
from bigdl_tpu.serving import ServingEngine as JaxEngine
from bigdl_tpu_torch import convert, optim
from bigdl_tpu_torch.models.gpt import GPTForCausalLM
from bigdl_tpu_torch.nn import CrossEntropyCriterion
from bigdl_tpu_torch.serving import ServingEngine

CFG = dict(vocab_size=61, hidden_size=32, n_layers=2, n_heads=4,
           max_position=32)
B, T = 2, 16


@pytest.fixture(scope="module")
def ref():
    jm = JaxGPT(**CFG, tie_embeddings=False)
    params, _ = jm.setup(jax.random.PRNGKey(5), None)
    tree = jax.tree_util.tree_map(np.asarray, params)
    ids = np.random.RandomState(1).randint(0, 61, (B, T + 1)).astype(
        np.int32)
    return jm, tree, ids[:, :-1], ids[:, 1:].reshape(-1)


def _port(tree):
    tm = GPTForCausalLM(**CFG, tie_embeddings=False, device="cpu")
    tm.load_state_dict(convert.params_from_jax(tree))
    return tm


def test_head_is_its_own_weight(ref):
    _, tree, _, _ = ref
    tm = _port(tree)
    assert tm.head is not None and tm.head.bias is None
    assert tuple(tm.head.weight.shape) == (61, 32)
    back = convert.params_to_jax(tm.state_dict())
    np.testing.assert_array_equal(back["head"]["weight"],
                                  tree["head"]["weight"])
    assert GPTForCausalLM(**CFG, device="cpu").head is None
    drawn = convert.init_tree(tm, seed=3)["head"]["weight"]
    assert drawn.shape == (32, 61) and np.abs(drawn).max() <= 32 ** -0.5
    assert "head" not in convert.init_tree(
        GPTForCausalLM(**CFG, device="cpu"), seed=3)


def test_logits_match_reference(ref):
    jm, tree, x, _ = ref
    want = np.asarray(jm.apply(jax.tree_util.tree_map(jnp.asarray, tree),
                               (), jnp.asarray(x))[0])
    with torch.no_grad():
        got = _port(tree)(torch.from_numpy(x).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_adam_step_matches_reference(ref):
    jm, tree, x, y = ref
    method = jmethods.Adam(learningrate=0.01)
    step = jax_train_step(jm, JaxCE(), method)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    params, _, _, jloss = step(params, (), method.init_state(params),
                               jax.random.PRNGKey(1), jnp.asarray(x),
                               jnp.asarray(y))
    tm = _port(tree)
    tmethod = optim.Adam(learningrate=0.01)
    tstep = optim.make_train_step(tm, CrossEntropyCriterion(), tmethod)
    loss = tstep(tmethod.init_state(dict(tm.named_parameters())),
                 torch.from_numpy(x).long(), torch.from_numpy(y).long())
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    got = convert.params_to_jax(tm.state_dict())
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    flat_w = jax.tree_util.tree_leaves(params)
    assert len(flat_g) == len(flat_w)
    for (path, g), w in zip(flat_g, flat_w):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-6,
                                   err_msg=str(path))


def test_greedy_tokens_match_reference(ref):
    jm, tree, x, _ = ref
    want = np.asarray(jm.generate(jax.tree_util.tree_map(jnp.asarray, tree),
                                  jnp.asarray(x[:1, :8]), 8))
    got = _port(tree).generate(torch.from_numpy(x[:1, :8]).long(), 8,
                               temperature=0.0).numpy()
    np.testing.assert_array_equal(got, want)


TP_PROMPTS = [[5, 9, 2, 17, 3], [1, 1, 4, 60, 8], [7, 3, 3],
              [9, 9, 9, 1, 0, 2, 4]]
TP_ENGINE = {False: dict(max_slots=3, paged=False),
             True: dict(max_slots=3, paged=True, kv_bytes=1 << 20,
                        page_size=8, prefill_chunk=4)}


def _serve(engine, n_new=8):
    try:
        with engine.scheduler._cond:
            handles = [engine.submit(p, n_new) for p in TP_PROMPTS]
        return [list(map(int, engine.result(h, timeout=120.0)))
                for h in handles]
    finally:
        engine.shutdown()


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("vocab", [64, 61])
def test_tp2_serves_the_untied_head(multi_device_cpu, vocab, paged):
    cfg = dict(CFG, vocab_size=vocab, max_position=64)
    jm = JaxGPT(**cfg, tie_embeddings=False)
    params, _ = jm.setup(jax.random.PRNGKey(3), None)
    want = _serve(JaxEngine(jm, params, tp=2, **TP_ENGINE[paged]))
    sd = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, params))

    def port(tp):
        m = GPTForCausalLM(**cfg, tie_embeddings=False, device="cpu")
        return ServingEngine(m, sd, device="cpu", tp=tp, **TP_ENGINE[paged])

    sharded = port(2)
    heads = [s.head.weight.shape for s in sharded.model.gpt.shards]
    assert heads == [(vocab // 2 if vocab % 2 == 0 else vocab, 32)] * 2
    assert _serve(sharded) == want
    assert _serve(port(1)) == want
