"""The port's speculative decoding (``bigdl_tpu_torch/models/spec.py``, the
verify forwards ``GPT.decode_chunk`` / ``GPT.paged_verify_chunk`` and
``GPTForCausalLM.generate(spec_tokens=)``) against the JAX reference
(``bigdl_tpu/models/spec.py``, ``bigdl_tpu/models/gpt.py``), on the CPU,
on the same seeded weights (``convert``).

Tolerances: the acceptance rule, the draft tables and every token exactly
equal (integers); the verify forwards' hidden states and caches within
1e-5 (atol = rtol; float32, the same products summed in another order).

The draft's scatters with repeated (row, prev) pairs keep the last pair in
row-major order (``models.spec.set_last``); the reference's XLA CPU
scatter writes in order, so its tables are held on such inputs too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.models import spec as jspec
from bigdl_tpu.models.gpt import GPTForCausalLM as JaxGPT
from bigdl_tpu_torch import convert
from bigdl_tpu_torch.models import spec
from bigdl_tpu_torch.models.gpt import GPTForCausalLM

CFG = dict(vocab_size=61, hidden_size=32, n_layers=2, n_heads=4,
           max_position=64)
TOL = dict(rtol=1e-5, atol=1e-5)
PROMPTS = [[5, 9, 2, 5, 9, 2, 5, 9], [1, 1, 4, 60, 8, 3, 3, 7]]


def _pair(seed=1, **kw):
    cfg = {**CFG, **kw}
    jm = JaxGPT(**cfg)
    params, _ = jm.setup(jax.random.PRNGKey(seed), None)
    tm = GPTForCausalLM(**cfg, device="cpu")
    tm.load_state_dict(convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    tm.requires_grad_(False)
    return jm, params, tm


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _np(x):
    return np.asarray(x)


# ------------------------------------------------------- acceptance rule --
def _verify_inputs(rng, b, c, v, agree):
    """Proposals and logits whose argmax chain agrees with the proposals
    for ``agree[b]`` positions a row (``agree`` None: random)."""
    logits = rng.standard_normal((b, c, v)).astype(np.float32)
    greedy = logits.argmax(-1)
    props = rng.integers(0, v, (b, c)).astype(np.int32)
    if agree is not None:
        for r, n in enumerate(agree):
            props[r, 1:n] = greedy[r, :n - 1]
            if n < c:
                props[r, n] = (greedy[r, n - 1] + 1) % v
    return props, logits


@pytest.mark.parametrize("agree", [None, [1, 2, 3, 4, 4, 1],
                                   [4, 4, 4, 4, 4, 4], [1] * 6],
                         ids=["random", "mixed", "all", "none"])
def test_accept_counts_matches_reference(agree):
    props, logits = _verify_inputs(np.random.default_rng(0), 6, 4, 17,
                                   agree)
    jacc, jcarry = jspec.accept_counts(jnp.asarray(props),
                                       jnp.asarray(logits))
    acc, carry = spec.accept_counts(torch.from_numpy(props),
                                    torch.from_numpy(logits))
    np.testing.assert_array_equal(acc.numpy(), _np(jacc))
    np.testing.assert_array_equal(carry.numpy(), _np(jcarry))
    assert acc.dtype == torch.int32
    assert ((acc >= 1) & (acc <= 4)).all()
    if agree is not None:
        assert acc.tolist() == agree


@pytest.mark.parametrize("masks", ["sampled", "inactive", "both", "none"])
def test_accept_serving_freezes_rows_as_reference(masks):
    props, logits = _verify_inputs(np.random.default_rng(1), 6, 4, 13,
                                   [4, 3, 4, 2, 1, 4])
    sampled = np.array([False, True, False, True, False, False])
    live = np.array([True, True, False, False, True, True])
    kw = {"sampled": sampled if masks in ("sampled", "both") else None,
          "live": live if masks in ("inactive", "both") else None}
    jadv, jcarry = jspec.accept_serving(
        jnp.asarray(props), jnp.asarray(logits),
        **{k: None if v is None else jnp.asarray(v) for k, v in kw.items()})
    adv, carry = spec.accept_serving(
        torch.from_numpy(props), torch.from_numpy(logits),
        **{k: None if v is None else torch.from_numpy(v)
           for k, v in kw.items()})
    np.testing.assert_array_equal(adv.numpy(), _np(jadv))
    np.testing.assert_array_equal(carry.numpy(), _np(jcarry))
    alive = live if kw["live"] is not None else np.ones(6, bool)
    assert (adv.numpy()[~alive] == 0).all()
    if kw["sampled"] is not None:
        assert (adv.numpy()[sampled & alive] == 1).all()


# ------------------------------------------------------------ the draft --
def _prime_case(kind, rng):
    """(state rows, ids, length, rows, prev) of one prime case."""
    v = 23
    if kind == "distinct":                      # no repeated (row, prev)
        ids = np.stack([rng.permutation(v)[:9] for _ in range(3)])
        return 3, ids, [9, 5, 7], None, None
    ids = rng.integers(0, 4, (3, 12))           # many repeated pairs
    if kind == "repeats":
        return 3, ids, [12, 9, 3], None, None
    if kind == "rows_oob":                      # rows past the table drop
        return 2, ids, [12, 12, 6], [1, 5, 0], None
    return 3, ids, [12, 4, 0], [2, 0, 1], [v, 3, 7]   # chunk: prev given


@pytest.mark.parametrize("kind", ["distinct", "repeats", "rows_oob",
                                  "chunk_prev"])
def test_ngram_prime_matches_reference(kind):
    n_rows, ids, length, rows, prev = _prime_case(
        kind, np.random.default_rng(2))
    jd, td = jspec.NGramDraft(23), spec.NGramDraft(23)

    def arg(x, mod):
        return None if x is None else mod.asarray(x, dtype=mod.int32)

    want = jd.prime(jd.init_state(n_rows), jnp.asarray(ids, jnp.int32),
                    jnp.asarray(length), rows=arg(rows, jnp),
                    prev=arg(prev, jnp))
    got = td.prime(td.init_state(n_rows), torch.as_tensor(ids),
                   torch.as_tensor(length),
                   rows=None if rows is None else torch.as_tensor(rows),
                   prev=None if prev is None else torch.as_tensor(prev))
    assert got.dtype == torch.int32 and got.shape == (n_rows, 23)
    np.testing.assert_array_equal(got.numpy(), _np(want))


def test_ngram_observe_and_propose_match_reference():
    """A masked observe (rejected positions are never learned) onto a
    primed table, then chained proposals from every row."""
    rng = np.random.default_rng(3)
    jd, td = jspec.NGramDraft(11), spec.NGramDraft(11)
    ids = rng.integers(0, 11, (4, 10)).astype(np.int32)
    jst = jd.prime(jd.init_state(4), jnp.asarray(ids), jnp.full((4,), 10))
    tst = td.prime(td.init_state(4), torch.from_numpy(ids),
                   torch.full((4,), 10))
    prevs = rng.integers(0, 11, (4, 4)).astype(np.int32)
    toks = rng.integers(0, 11, (4, 4)).astype(np.int32)
    mask = np.arange(4)[None, :] < np.array([[4], [2], [0], [1]])
    jst = jd.observe(jst, jnp.asarray(prevs), jnp.asarray(toks),
                     jnp.asarray(mask))
    tst = td.observe(tst, torch.from_numpy(prevs), torch.from_numpy(toks),
                     torch.from_numpy(mask))
    np.testing.assert_array_equal(tst.numpy(), _np(jst))
    tok0 = np.array([3, 0, 7, 10], np.int32)
    np.testing.assert_array_equal(
        td.propose(tst, torch.from_numpy(tok0), 5).numpy(),
        _np(jd.propose(jst, jnp.asarray(tok0), 5)))


def test_set_last_keeps_last_pair_and_drops_out_of_bounds():
    """``set_last`` against a Python loop in row-major order: the last of
    repeated pairs wins, out-of-bounds rows and the sentinel column drop,
    and a pair at the table's last cell survives the dropped pairs that
    rewrite that cell."""
    rng = np.random.default_rng(4)
    for _ in range(20):
        rows = rng.integers(0, 4, 40)                # 3 is out of bounds
        cols = rng.integers(0, 6, 40)                # 5 is the sentinel
        vals = rng.integers(0, 100, 40)
        rows[-1], cols[-1] = 2, 4                    # the last cell
        state = torch.as_tensor(rng.integers(0, 100, (3, 5)),
                                dtype=torch.int32)
        want = state.clone().numpy()
        for r, c, v in zip(rows, cols, vals):
            if r < 3 and c < 5:
                want[r, c] = v
        spec.set_last(state, torch.as_tensor(rows), torch.as_tensor(cols),
                      torch.as_tensor(vals))
        np.testing.assert_array_equal(state.numpy(), want)


@pytest.mark.parametrize("env, kw, want", [
    ({}, {}, 1),
    ({"BIGDL_TPU_SPEC_DECODE": "1"}, {}, 4),
    ({"BIGDL_TPU_SPEC_DECODE": "1", "BIGDL_TPU_SPEC_TOKENS": "6"}, {}, 6),
    ({"BIGDL_TPU_SPEC_DECODE": "1"}, {"spec_decode": False}, 1),
    ({}, {"spec_decode": True, "spec_tokens": 2}, 2),
    ({"BIGDL_TPU_SPEC_TOKENS": "3"}, {"spec_decode": True}, 3),
    ({"BIGDL_TPU_SPEC_DECODE": "1", "BIGDL_TPU_SPEC_TOKENS": "0"}, {}, 1),
], ids=["off", "flag", "flag_tokens", "arg_off", "args", "arg_on_env_len",
        "zero_tokens"])
def test_spec_config_flag_rule_matches_reference(env, kw, want,
                                                 monkeypatch):
    for name in ("BIGDL_TPU_SPEC_DECODE", "BIGDL_TPU_SPEC_TOKENS"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    assert spec.spec_config(**kw) == jspec.spec_config(**kw) == want


# ----------------------------------------------------- verify forwards --
@pytest.mark.parametrize("pos", [[5, 9, 2], [60, 62, 64]],
                         ids=["inside", "past_max_position"])
def test_decode_chunk_matches_reference(pair, pos):
    """A prefill of 12 positions, then a verify chunk of 4 tokens a row at
    per-row committed lengths: hidden states and both caches within 1e-5.
    Past ``max_position`` (64) the writes are dropped and the position
    embedding clipped, as in the reference."""
    jm, params, tm = pair
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 61, (3, 16)).astype(np.int32)
    toks = rng.integers(0, 61, (3, 4)).astype(np.int32)
    jc = jm.gpt.init_cache(3)
    _, jc = jm.gpt.prefill(params["gpt"], jc, jnp.asarray(ids), 12)
    jh, jc = jm.gpt.decode_chunk(params["gpt"], jc, jnp.asarray(toks),
                                 jnp.asarray(pos))
    tc = tm.gpt.init_cache(3)
    _, tc = tm.gpt.prefill(tc, ids, 12)
    th, tc = tm.gpt.decode_chunk(tc, torch.from_numpy(toks), np.array(pos))
    assert th.shape == (3, 4, 32)
    np.testing.assert_allclose(th.numpy(), _np(jh), **TOL)
    for tl, jl in zip(tc, jc):
        for name in ("k", "v"):
            np.testing.assert_allclose(tl[name].numpy(), _np(jl[name]),
                                       **TOL)


def test_paged_verify_chunk_matches_reference(pair):
    """Two slots prefilled through page tables, then a verify chunk of 4
    at their committed lengths (one straddling a page boundary): hidden
    states and the written pools within 1e-5 (the reference's XLA path;
    every row has pages)."""
    jm, params, tm = pair
    ps, n_pages = 8, 12
    table = np.full((2, 8), n_pages, np.int32)
    table[0, :3] = [4, 0, 7]
    table[1, :2] = [2, 9]
    lens = np.array([14, 6], np.int32)
    rng = np.random.default_rng(6)
    ids = rng.integers(0, 61, (2, 16)).astype(np.int32)
    toks = rng.integers(0, 61, (2, 4)).astype(np.int32)
    zeros = np.zeros(2, np.int32)
    jp = jm.gpt.init_paged_pool(n_pages, ps)
    _, jp = jm.gpt.paged_prefill_chunk(params["gpt"], jp, table,
                                       jnp.asarray(ids), zeros, lens,
                                       zeros, ps)
    jh, jp = jm.gpt.paged_verify_chunk(params["gpt"], jp, table,
                                       jnp.asarray(toks), lens, ps)
    tp = tm.gpt.init_paged_pool(n_pages, ps)
    _, tp = tm.gpt.paged_prefill_chunk(tp, table, ids, zeros, lens, zeros,
                                       ps)
    th, tp = tm.gpt.paged_verify_chunk(tp, table, torch.from_numpy(toks),
                                       lens, ps)
    np.testing.assert_allclose(th.numpy(), _np(jh), **TOL)
    for tl, jl in zip(tp, jp):
        for name in ("k", "v"):
            np.testing.assert_allclose(tl[name].numpy(), _np(jl[name]),
                                       **TOL)


# --------------------------------------------------------------- generate --
@pytest.mark.parametrize("gamma, n_new, prompts, max_position", [
    (4, 32, PROMPTS, 64), (2, 20, PROMPTS, 64), (4, 40, [[7, 3, 3, 1, 2]], 64),
    (3, 17, [[9, 9, 9, 1, 0, 2, 4, 11, 12, 13, 14, 15, 16]] * 2, 32)],
    ids=["g4", "g2", "single_long", "near_max_position"])
def test_generate_spec_tokens_match_reference(gamma, n_new, prompts,
                                              max_position):
    """Greedy ``generate(spec_tokens=gamma)``: the reference's speculative
    tokens, and the port's own plain tokens, exactly. The last case runs
    its verify chunks past ``max_position`` 32 (13 + 17 + gamma), where
    the writes drop. ``decode_stats`` maps the reference's budget of one
    prefill and one decode loop, two dispatches a call."""
    jm, params, tm = _pair(seed=1, max_position=max_position)
    ids = np.array(prompts, np.int32)
    want = _np(jm.generate(params, jnp.asarray(ids), n_new,
                           spec_tokens=gamma))
    plain = tm.generate(ids, n_new)
    before = tm.decode_stats.snapshot()
    got = tm.generate(ids, n_new, spec_tokens=gamma)
    after = tm.decode_stats.snapshot()
    assert got.dtype == torch.int32 and got.shape == plain.shape
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    assert after["prefill_traces"] - before["prefill_traces"] == 1
    assert after["decode_traces"] - before["decode_traces"] == 1
    assert after["dispatches"] - before["dispatches"] == 2


def test_generate_spec_flag_and_sliding(pair, monkeypatch):
    """``BIGDL_TPU_SPEC_DECODE`` turns speculation on for greedy
    ``generate`` (the same tokens); a generation past ``max_position``
    takes the sliding loop, as in the reference."""
    _, _, tm = pair
    ids = np.array(PROMPTS, np.int32)
    plain = tm.generate(ids, 12)
    monkeypatch.setenv("BIGDL_TPU_SPEC_DECODE", "1")
    monkeypatch.setenv("BIGDL_TPU_SPEC_TOKENS", "3")
    np.testing.assert_array_equal(tm.generate(ids, 12).numpy(),
                                  plain.numpy())
    before = tm.decode_stats.snapshot()
    out = tm.generate(ids, 60)
    assert out.shape == (2, 68)
    assert tm.decode_stats.snapshot() == before   # sliding counts nothing
