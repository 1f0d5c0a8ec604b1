"""Speculative serving in the port (``ServingEngine(spec_tokens=)`` over the
dense ``SlotManager`` and the paged ``PagedSlotManager``, at tp 1 and 2,
with int8 weights and K/V) against the JAX reference's speculative
engines and managers, on the CPU, on the same seeded weights (``convert``).

At temperature 0 speculation must not change a token: the port's
speculative tokens equal the reference's speculative ones and the port's
own plain ones, exactly, with chunked prefill, mid-flight admission and
``steps_per_sync`` 2. The accept counters of a greedy request depend only
on its own stream, so they equal the reference's too. A rejected proposal
must never reach a page shared through the prefix cache.

Int8 weights couple a dispatch's rows (one activation amax a batch, the
junk rows of inactive slots included), so the int8 full stack is held
through both packages' ``PagedSlotManager`` driven by hand in one fixed
order, against the reference on its Pallas kernel path
(``BIGDL_TPU_PAGED_KERNEL=1``, interpret mode: an inactive slot's rows are
zeros there, as in the port's kernel) and on its XLA gather path (its
inactive rows attend to clamped pages; the tokens agree on these weights).
"""

import jax
import numpy as np
import pytest

from bigdl_tpu.models.gpt import GPTForCausalLM as JaxGPT
from bigdl_tpu.nn.quantized import quantize_params
from bigdl_tpu.serving import ServingEngine as JaxEngine
from bigdl_tpu.serving import paging as jax_paging
from bigdl_tpu.serving import slots as jax_slots
from bigdl_tpu_torch import convert
from bigdl_tpu_torch.models.gpt import GPTForCausalLM
from bigdl_tpu_torch.nn import quantize_model
from bigdl_tpu_torch.ops.paged_attention import paged_pool_attention
from bigdl_tpu_torch.serving import (PagedSlotManager, ServingEngine,
                                     SlotManager)

CFG = dict(vocab_size=61, hidden_size=32, n_layers=2, n_heads=4,
           max_position=64)
PROMPTS = [[5, 9, 2, 17, 3], [1, 1, 4, 60, 8], [7, 3, 3],
           [9, 9, 9, 1, 0, 2, 4], [2, 4], [11, 12, 13, 14, 15, 16]]
WAIT = 120.0
N_NEW = 12
SPEC_KEYS = ("spec_proposed", "spec_accepted", "spec_rollbacks")


def _weights(seed):
    jm = JaxGPT(**CFG)
    params, _ = jm.setup(jax.random.PRNGKey(seed), None)
    return jm, params, convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params))


def _model(sd):
    m = GPTForCausalLM(**CFG, device="cpu")
    m.load_state_dict(sd)
    m.requires_grad_(False)
    return m


def _serve(engine, prompts=PROMPTS, n_new=N_NEW, **kw):
    try:
        hs = [engine.submit(p, n_new, **kw) for p in prompts]
        return [np.asarray(engine.result(h, timeout=WAIT)) for h in hs], \
            engine.metrics()
    finally:
        engine.shutdown()


def _serve_burst(engine, prompts=PROMPTS, n_new=N_NEW):
    """:func:`_serve` with every prompt submitted while the scheduler waits
    on its lock: its first admission pass sees the whole burst, so the
    admission batches (and the rows and slots each request gets) are the
    same in every run, whatever the threads' timing."""
    try:
        with engine.scheduler._cond:
            hs = [engine.submit(p, n_new) for p in prompts]
        return [np.asarray(engine.result(h, timeout=WAIT)) for h in hs], \
            engine.metrics()
    finally:
        engine.shutdown()


def _port(sd, **kw):
    return ServingEngine(_model(sd), None, device="cpu", **kw)


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


ENGINES = {
    "dense_mid_flight": dict(max_slots=3, prefill_window=2, max_queue=16),
    "dense_block_of_2": dict(max_slots=4, steps_per_sync=2),
    "dense_gamma_3": dict(max_slots=4, spec_tokens=3),
    "paged_chunked": dict(max_slots=4, paged=True, prefill_chunk=4,
                          page_size=16),
    "paged_mid_flight": dict(max_slots=3, paged=True, prefill_chunk=4,
                             page_size=8, max_queue=16),
    "paged_block_of_2": dict(max_slots=4, paged=True, prefill_chunk=4,
                             page_size=16, steps_per_sync=2,
                             spec_tokens=3),
}


@pytest.mark.parametrize("name", list(ENGINES))
def test_spec_engine_tokens_match_reference(name):
    """Six prompts, 12 greedy tokens each: the port's speculative engine
    gives the reference's speculative tokens and the port's plain ones;
    its accept counters are the reference's and add up."""
    jm, params, sd = _weights(2)
    kw = {"spec_tokens": 4, **ENGINES[name]}
    want, jmet = _serve(JaxEngine(jm, params, **kw))
    plain, _ = _serve(_port(sd, **{**kw, "spec_tokens": 1}))
    got, met = _serve(_port(sd, **kw))
    _same(got, want)
    _same(got, plain)
    assert met["retired"] == len(PROMPTS) and met["paged"] == ("paged" in kw)
    assert [met[k] for k in SPEC_KEYS] == [jmet[k] for k in SPEC_KEYS]
    assert met["spec_proposed"] == met["spec_accepted"] \
        + met["spec_rollbacks"] > 0
    assert met["spec_accept_rate"] == met["spec_accepted"] \
        / met["spec_proposed"]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_spec_tp2_matches_unsharded(paged):
    """Tensor-parallel speculation over two CPU shards (the verify chunks
    split by head, the draft on the first shard's device): the tokens of
    the reference's unsharded speculative engine and of the port's plain
    unsharded engine. Six prompts on three slots: each engine gets the
    burst in one admission pass (:func:`_serve_burst`), so the three see
    the same admission batches; with the submits racing the scheduler the
    batches followed the threads' timing, and under a loaded machine the
    tp-2 run could see other ones than the reference did."""
    jm, params, sd = _weights(3)
    kw = dict(max_slots=3, max_queue=16)
    if paged:
        kw.update(paged=True, page_size=8, prefill_chunk=4)
    want, _ = _serve_burst(JaxEngine(jm, params, spec_tokens=4, **kw))
    plain, _ = _serve_burst(_port(sd, **kw))
    # the engine reports the process-wide count: an earlier test file in
    # this process may have run sharded calls of its own
    before = paged_pool_attention.sharded_calls
    got, met = _serve_burst(_port(sd, spec_tokens=4, tp=2, **kw))
    _same(got, want)
    _same(got, plain)
    assert met["tp_degree"] == 2 and met["spec_proposed"] > 0
    # one sharded call a layer and dispatch on the paged path
    assert (met["sharded_attention_calls"] - before > 0) == paged


def test_sampled_rows_ride_the_spec_batch():
    """A sampled request commits one token an iteration from the carried
    distribution, with one noise draw an iteration: its stream is the same
    with speculation on and off, as is its greedy neighbour's."""
    _, _, sd = _weights(4)
    outs = []
    for spec in (1, 4):
        eng = _port(sd, max_slots=4, seed=7, top_k=10, top_p=0.9,
                    spec_tokens=spec)
        try:
            hs = [eng.submit(PROMPTS[0], 10, temperature=0.8),
                  eng.submit(PROMPTS[1], 10)]
            outs.append([eng.result(h, timeout=WAIT) for h in hs])
            met = eng.metrics()
        finally:
            eng.shutdown()
    _same(*outs)
    # the sampled row never counts as a rejection
    assert met["spec_proposed"] == met["spec_accepted"] \
        + met["spec_rollbacks"]
    assert met["sampled_steps"] > 0


def test_spec_rollback_never_corrupts_shared_pages():
    """Two prompts sharing a full page decode speculatively one after the
    other, then the first again: every verify write (rejected ones too)
    lands on copied or freshly owned pages, never on the shared prefix, so
    all three streams equal the plain engine's and the reference's."""
    jm, params, sd = _weights(9)
    common = list((np.arange(16) * 7) % 61)          # exactly one page
    a, b = common + [1, 2, 3], common + [4, 5, 6]
    kw = dict(max_slots=4, paged=True, page_size=16, max_queue=32)
    plain, _ = _serve(_port(sd, **kw), [a, b], 10)
    jeng = JaxEngine(jm, params, spec_tokens=4, **kw)
    try:
        want = [np.asarray(jeng.result(jeng.submit(p, 10), timeout=WAIT))
                for p in (a, b, a)]
    finally:
        jeng.shutdown()
    eng = _port(sd, spec_tokens=4, **kw)
    try:
        got = [eng.result(eng.submit(p, 10), timeout=WAIT)
               for p in (a, b, a)]
        met = eng.metrics()
    finally:
        eng.shutdown()
    _same(got, want)
    _same(got, plain + plain[:1])
    assert met["prefix_hit_tokens"] >= 32            # b and a again hit


def _drive(pm, prompts, n_new):
    """Admit ``prompts`` on a manager, then speculative blocks until every
    slot has ``n_new`` committed tokens; returns them in slot order."""
    slots = pm.admit(prompts)
    gen = {s: [] for s in slots}
    while min(len(g) for g in gen.values()) < n_new:
        pm.reserve_block()
        toks = np.asarray(pm.step())
        for s in slots:
            gen[s].extend(int(t) for t in toks[:pm.last_counts[s], s])
    return [gen[s][:n_new] for s in slots]


def test_spec_identical_streams_cow_on_manager():
    """Two admissions of one prompt share every page; the speculative
    blocks (reserving ``block_span`` positions) copy the shared boundary
    page before writing, so both streams are the plain stream."""
    jm, params, sd = _weights(9)
    p, n_new = PROMPTS[0], 8
    plain, _ = _serve(_port(sd, max_slots=1), [p], n_new)
    pm = PagedSlotManager(_model(sd), max_slots=4, page_size=16,
                          spec_tokens=4)
    assert pm.block_span == 4
    got = _drive(pm, [p, p], n_new)
    assert pm.pool_stats()["prefix_hit_tokens"] == len(p)
    assert pm.cow_copies >= 1
    tail = plain[0][len(p):].tolist()
    assert got == [tail, tail]
    jpm = jax_paging.PagedSlotManager(jm, params, 4, page_size=16,
                                      spec_tokens=4)
    assert _drive(jpm, [p, p], n_new) == got


@pytest.mark.parametrize("kernel", [True, False],
                         ids=["jax_kernel", "jax_gather"])
def test_int8_full_stack_hand_driven_matches_reference(kernel, monkeypatch):
    """Speculation over int8 weights and int8 K/V pages, chunked prefill
    of 4: four prompts through both packages' ``PagedSlotManager`` in one
    fixed order, 12 tokens each, identical; so are the accept counters
    (see module docstring for the two reference paths)."""
    monkeypatch.setenv("BIGDL_TPU_PAGED_KERNEL", "1" if kernel else "0")
    jm, params, sd = _weights(6)
    kw = dict(page_size=16, prefill_chunk=4, window=4, spec_tokens=4)
    jpm = jax_paging.PagedSlotManager(jm, quantize_params(params), 4,
                                      int8_kv=True, **kw)
    want = _drive(jpm, PROMPTS[:4], N_NEW)
    pm = PagedSlotManager(quantize_model(_model(sd)), 4, int8_kv=True, **kw)
    got = _drive(pm, PROMPTS[:4], N_NEW)
    assert got == want
    assert pm.pool_stats()["kv_dtype"] == "int8"
    assert (pm.spec_proposed, pm.spec_accepted, pm.spec_rollbacks) == (
        jpm.spec_proposed, jpm.spec_accepted, jpm.spec_rollbacks)


@pytest.mark.parametrize("kw", [
    dict(int8_weights=True), dict(paged=True, int8_weights=True,
                                  int8_kv=True),
    dict(paged=True, tp=2, int8_weights=True, int8_kv=True),
    dict(tp=2, int8_weights=True)],
    ids=["dense_int8w", "paged_int8", "paged_tp2_int8", "dense_tp2_int8w"])
def test_int8_spec_engines_serve(kw):
    """``spec_tokens=4`` with int8 weights (and int8 K/V, and tp 2) serves
    on every table: each request retires with its tokens, the draft
    proposes, and the int8 products run."""
    _, _, sd = _weights(5)
    outs, met = _serve(_port(sd, max_slots=3, spec_tokens=4,
                             **({"page_size": 8, "prefill_chunk": 4}
                                if kw.get("paged") else {}), **kw))
    assert [o.size for o in outs] == [len(p) + N_NEW for p in PROMPTS]
    assert met["retired"] == len(PROMPTS) and met["spec_proposed"] > 0
    assert met["int8_matmuls"] > 0
    assert met["kv_dtype"] == ("int8" if kw.get("int8_kv") else "float32")


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_spec_accept_rate_on_repetitive_stream(paged):
    """A stream that settles into a cycle is the bigram draft's best case:
    over 48 tokens the accept rate clears 0.5, the counters add up, and
    they are the reference's."""
    jm, params, sd = _weights(1)
    kw = dict(max_slots=2, spec_tokens=4)
    if paged:
        kw.update(paged=True, page_size=16)
    _, jmet = _serve(JaxEngine(jm, params, **kw), [[5, 9, 2]], 48)
    _, met = _serve(_port(sd, **kw), [[5, 9, 2]], 48)
    assert met["spec_accept_rate"] >= 0.5
    assert met["spec_proposed"] == met["spec_accepted"] \
        + met["spec_rollbacks"]
    assert [met[k] for k in SPEC_KEYS] == [jmet[k] for k in SPEC_KEYS]


def test_dense_spec_manager_counts_contract():
    """``SlotManager.step()`` speculating returns a (block_span,
    max_slots) block with per-slot ``last_counts`` in [0, block_span]:
    the admitted slot commits 1..6, the free ones 0; the same as the
    reference's manager."""
    jm, params, sd = _weights(9)
    sm = SlotManager(_model(sd), max_slots=3, steps_per_sync=2,
                     spec_tokens=3)
    jsm = jax_slots.SlotManager(jm, params, 3, steps_per_sync=2,
                                spec_tokens=3)
    assert sm.block_span == jsm.block_span == 6
    s0 = sm.admit([PROMPTS[0]])[0]
    assert jsm.admit([PROMPTS[0]])[0] == s0
    toks = sm.step()
    jtoks = np.asarray(jsm.step())
    assert toks.shape == jtoks.shape == (6, 3)
    assert 1 <= sm.last_counts[s0] <= 6
    assert all(sm.last_counts[s] == 0 for s in range(3) if s != s0)
    np.testing.assert_array_equal(sm.last_counts, jsm.last_counts)
    n = sm.last_counts[s0]
    np.testing.assert_array_equal(toks[:n, s0], jtoks[:n, s0])
    assert sm.lengths[s0] == len(PROMPTS[0]) + n


def test_spec_flags_drive_engine(monkeypatch):
    """``BIGDL_TPU_SPEC_DECODE`` / ``_SPEC_TOKENS`` size the engine's
    draft when ``spec_tokens`` is not given; the keyword wins."""
    _, _, sd = _weights(3)
    monkeypatch.setenv("BIGDL_TPU_SPEC_DECODE", "1")
    monkeypatch.setenv("BIGDL_TPU_SPEC_TOKENS", "3")
    for paged in (False, True):
        with _port(sd, max_slots=2, paged=paged) as eng:
            assert eng.spec_tokens == eng.slots.spec_tokens == 3
            assert eng.slots.block_span == 3
            assert eng.generate(PROMPTS[0], 4, timeout=WAIT).size == 9
            assert eng.metrics()["spec_proposed"] > 0
    with _port(sd, max_slots=2, spec_tokens=1) as eng:
        assert eng.spec_tokens == 1 and "spec_proposed" not in eng.metrics()


def test_spec_block_cut_at_eos_and_max_tokens():
    """A speculative block can commit past a request's end: delivery cuts
    each column at ``last_counts``, then at the first EOS and at
    ``max_new_tokens``."""
    _, _, sd = _weights(1)
    plain, _ = _serve(_port(sd, max_slots=2), [[5, 9, 2]], 20)
    stream = plain[0][3:]
    eos = int(stream[6])
    first = int(np.nonzero(stream == eos)[0][0])
    with _port(sd, max_slots=2, spec_tokens=4) as eng:
        cut = eng.result(eng.submit([5, 9, 2], 20, eos_token=eos),
                         timeout=WAIT)
        short = eng.result(eng.submit([5, 9, 2], 5), timeout=WAIT)
    np.testing.assert_array_equal(cut, plain[0][:3 + first + 1])
    np.testing.assert_array_equal(short, plain[0][:8])
