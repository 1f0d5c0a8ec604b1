"""The port's dense K/V-cache path and ``generate``
(``bigdl_tpu_torch/parallel/sequence.py`` ``flash_profitable``,
``cached_attention`` and ``MultiHeadAttention.init_cache`` / ``prefill`` /
``decode_step``; ``bigdl_tpu_torch/models/gpt.py`` ``GPT.prefill`` /
``decode_step`` and ``GPTForCausalLM.generate``) against the JAX
reference, on the CPU, on the same seeded weights (``convert``).

Tolerances: attention and the layer outputs within 1e-5 (atol = rtol;
float32, the same products summed in another order); greedy tokens
identical, on the bucketed path and on the sliding fallback.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.models.gpt import GPTForCausalLM as JaxGPT
from bigdl_tpu.parallel import sequence as jax_seq
from bigdl_tpu_torch import convert
from bigdl_tpu_torch.models.gpt import GPTForCausalLM
from bigdl_tpu_torch.ops.flash_attention import flash_fwd
from bigdl_tpu_torch.parallel import sequence as seq

CFG = dict(vocab_size=61, hidden_size=32, n_layers=2, n_heads=4,
           max_position=64)
TOL = dict(rtol=1e-5, atol=1e-5)
PROMPTS = [[5, 9, 2, 17, 3], [1, 1, 4, 60, 8], [7, 3, 3],
           [9, 9, 9, 1, 0, 2, 4]]


def _pair(**kw):
    cfg = {**CFG, **kw}
    jm = JaxGPT(**cfg)
    params, _ = jm.setup(jax.random.PRNGKey(0), None)
    tm = GPTForCausalLM(**cfg, device="cpu")
    tm.load_state_dict(convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    tm.requires_grad_(False)
    return jm, params, tm


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("cur", [7, [3, 9, 16]], ids=["scalar", "vector"])
def test_cached_attention_matches_reference(cur):
    rng = np.random.default_rng(0)
    q, k, v = _rand(rng, 3, 4, 1, 8), _rand(rng, 3, 4, 16, 8), \
        _rand(rng, 3, 4, 16, 8)
    want = jax_seq.cached_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jnp.asarray(cur))
    got = seq.cached_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), torch.tensor(cur))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_flash_profitable_matches_reference():
    for t in [1, 127, 128, 1024, 1920, 2047, 2048, 2049, 2176, 4096, 8064,
              8192, 8200, 16384]:
        for causal in (False, True):
            assert seq.flash_profitable(t, causal) == \
                jax_seq.flash_profitable(t, causal)


@pytest.mark.parametrize("index", ["scalar", "vector"])
def test_mha_prefill_and_decode_step_match_reference(pair, index):
    """Layer 0's attention: a prefill of 6 positions into a 16-long cache,
    then one decode step at position 6 (every row) or at 6, 2 and 4 (one
    position a row): outputs and caches within 1e-5."""
    jm, params, tm = pair
    jattn, tattn = jm.gpt.layers[0].attn, tm.gpt.layers[0].attn
    p = params["gpt"]["layers"][0]["attn"]
    rng = np.random.default_rng(1)
    x, step = _rand(rng, 3, 6, 32), _rand(rng, 3, 1, 32)
    jc = jattn.init_cache(3, 16)
    jy, jc = jattn.prefill(p, jnp.asarray(x), jc)
    tc = tattn.init_cache(3, 16, torch.float32, "cpu")
    ty, tc = tattn.prefill(torch.from_numpy(x), tc)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    idx = 6 if index == "scalar" else [6, 2, 4]
    jy, jc = jattn.decode_step(p, jnp.asarray(step), jc, jnp.asarray(idx))
    ty, tc = tattn.decode_step(torch.from_numpy(step), tc, torch.tensor(idx))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   **TOL)


def test_gpt_prefill_and_decode_logits_match_reference(pair):
    """The stack's bucket-padded prefill (per-row prompt lengths) and three
    decode steps at per-row positions: next-token logits within 1e-5."""
    jm, params, tm = pair
    ids = np.zeros((2, 16), np.int32)
    ids[0, :5], ids[1, :3] = PROMPTS[0], PROMPTS[2]
    lens = np.array([5, 3], np.int32)
    jc = jm.gpt.init_cache(2)
    jh, jc = jm.gpt.prefill(params["gpt"], jc, jnp.asarray(ids),
                            jnp.asarray(lens))
    tc = tm.gpt.init_cache(2)
    th, tc = tm.gpt.prefill(tc, ids, lens)
    np.testing.assert_allclose(tm._lm_logits(th).numpy(),
                               np.asarray(jm._lm_logits(params, jh)), **TOL)
    pos = lens.copy()
    for tok in ([3, 4], [10, 11], [0, 60]):
        jh, jc = jm.gpt.decode_step(params["gpt"], jc, jnp.asarray(tok),
                                    jnp.asarray(pos))
        th, tc = tm.gpt.decode_step(tc, torch.tensor(tok), pos)
        np.testing.assert_allclose(
            tm._lm_logits(th).numpy(),
            np.asarray(jm._lm_logits(params, jh)), **TOL)
        pos = pos + 1


@pytest.mark.parametrize("max_position,n_new", [(64, 12), (16, 20)],
                         ids=["bucketed", "sliding"])
def test_generate_greedy_tokens_match_reference(max_position, n_new):
    """Greedy ``generate`` of a batch of two prompts: 12 new tokens within
    max_position 64 take the bucketed prefill and the decode loop; 20 past
    max_position 16 the sliding fallback (the reference's own sliding
    loop on the CPU: see ROADMAP queue C on its donated window at 64);
    both token-identical to the reference's."""
    jm, params, tm = _pair(max_position=max_position)
    ids = np.array([PROMPTS[0], PROMPTS[1]], np.int32)
    want = np.asarray(jm.generate(params, jnp.asarray(ids), n_new))
    before = dict(tm.decode_stats.snapshot())
    got = tm.generate(ids, n_new)
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    after = tm.decode_stats.snapshot()
    kv = n_new == 12                 # the sliding fallback counts nothing
    assert after["prefill_traces"] - before["prefill_traces"] == kv
    assert after["decode_traces"] - before["decode_traces"] == kv
    assert after["dispatches"] - before["dispatches"] == 2 * kv


def test_generate_single_prompt_and_sliding_equals_bucketed(pair):
    """A (T,) prompt generates as a batch of one; the sliding loop, run
    directly, gives the bucketed path's greedy tokens while the window
    holds the whole sequence (the reference's own identity)."""
    _, _, tm = pair
    out = tm.generate(PROMPTS[3], 10)
    assert out.shape == (1, len(PROMPTS[3]) + 10)
    sliding = tm._generate_sliding(torch.tensor([PROMPTS[3]],
                                                dtype=torch.int32), 10, 0.0,
                                   None)
    torch.testing.assert_close(out, sliding, rtol=0, atol=0)


@pytest.mark.parametrize("n_new", [12, 70], ids=["bucketed", "sliding"])
def test_generate_sampled_completes(pair, n_new):
    """A sampled run (top_k 10, top_p 0.9, temperature 0.8) through the
    fused sampler's plain version: every token in range; the same
    generator seed repeats the run."""
    _, _, tm = pair
    ids = np.array([PROMPTS[0], PROMPTS[1]], np.int32)
    runs = []
    for _ in range(2):
        g = torch.Generator().manual_seed(5)
        runs.append(tm.generate(ids, n_new, temperature=0.8, generator=g,
                                top_k=10, top_p=0.9))
    out = runs[0]
    assert out.shape == (2, 5 + n_new)
    assert ((out >= 0) & (out < CFG["vocab_size"])).all()
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)


def test_spec_tokens_raise_naming_a5(pair, monkeypatch):
    """Once a refusal naming ROADMAP A.5, now its parity case: greedy
    ``generate(spec_tokens=4)``, and with ``BIGDL_TPU_SPEC_DECODE``, gives
    the reference's speculative tokens and the port's plain ones; sampled
    generation ignores speculation, as the reference does, and an explicit
    ``spec_tokens=1`` wins over the flag (the plain loop: one token a
    decode step, no verify chunk)."""
    jm, params, tm = pair
    ids = np.array([PROMPTS[0], PROMPTS[1]], np.int32)
    want = np.asarray(jm.generate(params, jnp.asarray(ids), 12,
                                  spec_tokens=4))
    plain = tm.generate(ids, 12).numpy()
    np.testing.assert_array_equal(tm.generate(ids, 12, spec_tokens=4)
                                  .numpy(), want)
    np.testing.assert_array_equal(want, plain)
    monkeypatch.setenv("BIGDL_TPU_SPEC_DECODE", "1")
    np.testing.assert_array_equal(tm.generate(ids, 12).numpy(), plain)
    # sampled generation ignores speculation, as the reference does
    g = [torch.Generator().manual_seed(2) for _ in range(2)]
    sampled = tm.generate(PROMPTS[0], 4, temperature=0.8, generator=g[0])
    assert sampled.shape == (1, 9)
    monkeypatch.delenv("BIGDL_TPU_SPEC_DECODE")
    torch.testing.assert_close(
        tm.generate(PROMPTS[0], 4, temperature=0.8, generator=g[1]), sampled,
        rtol=0, atol=0)
    # an explicit spec_tokens=1 wins over the flag: no verify chunk runs
    monkeypatch.setenv("BIGDL_TPU_SPEC_DECODE", "1")
    calls = []
    monkeypatch.setattr(tm.gpt, "decode_chunk",
                        lambda *a: calls.append(a) or None)
    assert tm.generate(PROMPTS[0], 4, spec_tokens=1).shape == (1, 9)
    assert calls == []


def test_dense_prefill_takes_flash_only_past_the_gate(monkeypatch):
    """The prefill's attention route: on CPU tensors always
    ``full_attention``; on card tensors the flash kernel exactly where
    ``flash_profitable(t, True)`` holds. The card is faked: ``is_cuda``
    reads True and the flash call is recorded."""
    attn = seq.MultiHeadAttention(32, 4, causal=True, device="cpu")
    attn.requires_grad_(False)
    calls = []
    monkeypatch.setattr(seq, "flash_attention",
                        lambda q, k, v, causal: calls.append(q.shape[2])
                        or seq.full_attention(q, k, v, causal))
    launches = flash_fwd.launches
    for t in (128, 2048):
        x = torch.zeros(1, t, 32)
        attn.prefill_heads(x, attn.init_cache(1, t, torch.float32, "cpu"))
    assert calls == [] and flash_fwd.launches == launches

    class CardTensor(torch.Tensor):
        is_cuda = True

    for t in (128, 1920, 2048, 2049, 4096):
        x = torch.zeros(1, t, 32).as_subclass(CardTensor)
        attn.prefill_heads(x, attn.init_cache(1, t, torch.float32, "cpu"))
    assert calls == [2048, 4096]
