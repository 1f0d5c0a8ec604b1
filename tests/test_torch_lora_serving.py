"""Multi-tenant LoRA serving in the port (``ServingEngine(lora=True)`` over
the dense ``SlotManager`` and the paged ``PagedSlotManager``, with chunked
prefill, speculation, int8 weights and tp 2) against the reference's
multi-tenant engine, on the CPU, at the reference tests' tiny model (vocab
61, hidden 32, 2 layers, 4 heads, rank 4) with the same seeded weights and
adapters (``convert``), mirroring the reference's
``TestServingTokenIdentity``, ``TestPrefixIsolation``,
``TestSchedulerLifecycle`` and ``TestRecovery``.

A burst of requests (base and two tenants mixed) is submitted while the
engine's scheduler waits on its lock, so both packages admit the same
batches. Every greedy stream's tokens equal the reference engine's and
each request's single-adapter oracle, the port's (a hand-driven 2-slot
manager under ``models.lora.SingleAdapter``) and the reference's
(``generate`` over ``wrap_params_single``), exactly.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bigdl_tpu.models.gpt import GPTForCausalLM as JaxGPT
from bigdl_tpu.models.lora import init_adapter as jax_init_adapter
from bigdl_tpu.models.lora import wrap_params_single
from bigdl_tpu.serving import ServingEngine as JaxEngine
from bigdl_tpu_torch import convert
from bigdl_tpu_torch.models import lora
from bigdl_tpu_torch.models.gpt import GPTForCausalLM
from bigdl_tpu_torch.nn import quantize_model
from bigdl_tpu_torch.nn.quantized import lora_delta
from bigdl_tpu_torch.resilience import faults
from bigdl_tpu_torch.resilience.supervisor import EngineSupervisor
from bigdl_tpu_torch.serving import (AdapterLoadError, PagedSlotManager,
                                     ServingEngine, SlotManager)
from bigdl_tpu_torch.serving.paging import chain_seed
from bigdl_tpu_torch.serving.snapshot import (RequestJournal,
                                              requests_from_journal)

CFG = dict(vocab_size=61, hidden_size=32, n_layers=2, n_heads=4,
           max_position=64)
RANK = 4
WAIT = 120.0
N_NEW = 8
PROMPTS = [list(range(3, 3 + 12)), list(range(5, 5 + 12)),
           list(range(11, 11 + 12)), list(range(2, 2 + 12))]
# base, then the tenants in turn
PLAN = [(p, None if i == 0 else f"t{(i - 1) % 2}")
        for i, p in enumerate(PROMPTS)]
LORA = dict(lora=True, lora_rank=RANK, adapter_slots=2, max_queue=16)


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.configure(None)
    yield
    faults.configure(None)


@pytest.fixture(scope="module")
def pair():
    jm = JaxGPT(**CFG)
    params, _ = jm.setup(jax.random.PRNGKey(0), None)
    sd = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    jads = {f"t{i}": jax_init_adapter(jax.random.PRNGKey(100 + i), params,
                                      RANK, b_std=0.5) for i in range(3)}
    ads = {k: convert.adapter_from_jax(jax.tree_util.tree_map(np.asarray, v))
           for k, v in jads.items()}
    return jm, params, sd, jads, ads


def _model(sd, int8=False):
    m = GPTForCausalLM(**CFG, device="cpu")
    m.load_state_dict(sd)
    if int8:
        quantize_model(m)
    m.requires_grad_(False)
    return m


def _port(sd, **kw):
    return ServingEngine(_model(sd), None, device="cpu", **kw)


def _burst(engine, plan=PLAN, n_new=N_NEW):
    """Submit ``plan`` while the scheduler waits on its lock (one admission
    pass sees every request, whatever the threads' timing), then collect
    and shut down."""
    try:
        with engine.scheduler._cond:
            hs = [engine.submit(p, n_new, adapter=a) for p, a in plan]
        return [np.asarray(engine.result(h, timeout=WAIT)) for h in hs]
    finally:
        engine.shutdown()


_JAX_ORACLE = {}


def _jax_oracle(jm, params, jad, name, prompt, n_new=N_NEW):
    key = (name, tuple(prompt), n_new)
    if key not in _JAX_ORACLE:
        p = params if jad is None else wrap_params_single(params, jad)
        _JAX_ORACLE[key] = np.asarray(jm.generate(
            p, jnp.asarray(prompt, jnp.int32)[None], n_new))[0]
    return _JAX_ORACLE[key]


REFERENCE_RUNS = 3


def _reference_burst(jm, params, jads, kw, check=True):
    """The reference engine's tokens for ``PLAN``. With ``check`` (float
    weights) a run whose streams are not the reference's own
    ``generate`` oracles' is made again on a fresh engine, up to
    ``REFERENCE_RUNS`` runs in all, and the last run is returned: the
    port is held, exactly and first, to both oracles, and then to a
    reference engine run that agrees with the reference itself. (Under
    CPU load this case has failed now and then at the comparison with
    the reference engine's tokens; the greedy margins of these streams
    are at least 0.77 % of the top logit, so no rounding flips a token.)"""
    for _ in range(REFERENCE_RUNS):
        want = _burst(JaxEngine(jm, params, max_slots=len(PLAN),
                                adapters=jads, **LORA, **kw))
        if not check or all(
                np.array_equal(w, _jax_oracle(
                    jm, params, None if a is None else jads[a], a, p))
                for (p, a), w in zip(PLAN, want)):
            break
    return want


def _port_oracle(sd, ad, prompt, n_new=N_NEW, int8=False, paged=False):
    """Greedy tokens of ``prompt`` alone under ONE adapter (None: the base
    model): a hand-driven 2-slot manager whose every row runs under a
    ``SingleAdapter`` (unbatched slabs)."""
    m = _model(sd, int8)
    pool = None if ad is None else lora.SingleAdapter(ad, int8=int8)
    mgr = (PagedSlotManager(m, 2, page_size=8, adapter_pool=pool) if paged
           else SlotManager(m, 2, adapter_pool=pool))
    (s,) = mgr.admit([prompt])
    out = []
    while len(out) < n_new:
        mgr.reserve_block()
        out.append(int(mgr.step()[0, s]))
    return np.concatenate([np.asarray(prompt, np.int32), out])


ENGINES = {
    "dense": {},
    "paged_chunked": dict(paged=True, page_size=8, prefill_chunk=8),
    "paged_spec": dict(paged=True, page_size=8, spec_tokens=3),
    "paged_int8": dict(paged=True, page_size=8, int8_weights=True),
    "paged_tp2": dict(paged=True, page_size=8, tp=2),
    "dense_tp2_spec": dict(tp=2, spec_tokens=3),
}


@pytest.mark.parametrize("name", list(ENGINES))
def test_mixed_batch_tokens_match_reference_and_oracles(pair, name,
                                                        request):
    """Base and two tenants in one batch: the reference's multi-tenant
    engine's tokens, and each stream's single-adapter oracles' (the
    port's at the same int8 quantisation, and the reference's)."""
    jm, params, sd, jads, ads = pair
    kw = ENGINES[name]
    if "tp" in kw:
        # the reference's tp engine needs the virtual CPU devices
        request.getfixturevalue("multi_device_cpu")
    int8 = "int8_weights" in kw
    want = _reference_burst(jm, params, jads, kw, check=not int8)
    products = lora_delta.products
    eng = _port(sd, max_slots=len(PLAN), adapters=ads, **LORA, **kw)
    got = _burst(eng)
    met = eng.metrics()
    for (p, a), g, w in zip(PLAN, got, want):
        np.testing.assert_array_equal(
            g, _port_oracle(sd, None if a is None else ads[a], p, int8=int8,
                            paged="paged" in kw))
        if not int8:
            np.testing.assert_array_equal(
                g, _jax_oracle(jm, params, None if a is None else jads[a],
                               a, p))
        np.testing.assert_array_equal(g, w)
    assert met["retired"] == len(PLAN)
    assert met["adapter_loads"] == 2 and met["adapter_referenced"] == 0
    assert met["tp_degree"] == kw.get("tp", 1)
    assert met["lora_products"] > products
    # one gather a change of batch composition, never one a step
    dispatches = met["steps"] + met.get("prefills", 0) \
        + met.get("prefill_chunks", 0)
    assert 1 <= met["adapter_gathers"] < dispatches


def test_pool_less_engine_unchanged(pair):
    """Without a pool: the reference's tokens and no delta product; a
    request naming an adapter fails alone, typed. A pool-bound engine
    serving only the base model gives the same tokens with no delta
    product either (a base-only batch gathers nothing)."""
    jm, params, sd, _, ads = pair
    base_plan = [(p, None) for p in PROMPTS]
    want = _burst(JaxEngine(jm, params, max_slots=4), base_plan)
    products = lora_delta.products
    eng = _port(sd, max_slots=4)
    assert eng.adapter_pool is None
    try:
        bad = eng.submit(PROMPTS[1], 4, adapter="t0")
        with pytest.raises(AdapterLoadError, match="no adapter pool"):
            bad.result(WAIT)
    except BaseException:
        eng.shutdown()
        raise
    got = _burst(eng, base_plan)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    got = _burst(_port(sd, max_slots=4, adapters=ads, **LORA), base_plan)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert lora_delta.products == products
    with pytest.raises(ValueError, match="adapters= needs the pool"):
        _port(sd, adapters=ads)
    with pytest.raises(ValueError, match="lora=True"):
        _port(sd).register_adapter("t0", ads["t0"])


def test_lora_flags_build_the_pool(pair, monkeypatch):
    _, _, sd, _, ads = pair
    monkeypatch.setenv("BIGDL_TPU_LORA", "1")
    monkeypatch.setenv("BIGDL_TPU_LORA_RANK", str(RANK))
    monkeypatch.setenv("BIGDL_TPU_ADAPTER_SLOTS", "3")
    monkeypatch.setenv("BIGDL_TPU_ADAPTER_HOST_BYTES", str(1 << 22))
    eng = _port(sd, max_slots=2)
    try:
        pool = eng.adapter_pool
        assert (pool.rank, pool.capacity, pool.rows) == (RANK, 3, 4)
        assert pool.tier is not None and pool.tier.budget_bytes == 1 << 22
        dig = eng.register_adapter("t0", ads["t0"])
        out = eng.result(eng.submit(PROMPTS[1], 6, adapter=dig.hex()), WAIT)
        np.testing.assert_array_equal(
            out, _port_oracle(sd, ads["t0"], PROMPTS[1], 6))
        assert eng.metrics()["adapter_capacity"] == 3
    finally:
        eng.shutdown()
    monkeypatch.setenv("BIGDL_TPU_LORA", "0")
    with _port(sd, max_slots=2) as e:
        assert e.adapter_pool is None


def test_chain_seed_domain_separation():
    d1, d2 = bytes(range(16)), bytes(range(1, 17))
    assert chain_seed(None) == chain_seed() == b"bigdl-tpu-prefix-v1"
    assert len({chain_seed(None), chain_seed(d1), chain_seed(d2)}) == 3
    assert chain_seed(d1) == chain_seed(d1)
    from bigdl_tpu.serving.paging import chain_seed as jax_chain_seed
    assert chain_seed(d1) == jax_chain_seed(d1)


def test_cross_adapter_prefix_never_shared(pair):
    """The same two-page prompt under the base model and two tenants
    misses the prefix cache every time; a same-tenant resubmit hits."""
    _, _, sd, _, ads = pair
    prompt = list(range(1, 17))
    eng = _port(sd, max_slots=2, paged=True, page_size=8, adapters=ads,
                **LORA)
    try:
        def miss(adapter):
            before = eng.slots.prefix_miss_tokens
            eng.result(eng.submit(prompt, 4, adapter=adapter), WAIT)
            return eng.slots.prefix_miss_tokens - before

        assert [miss(a) for a in (None, "t0", "t1", "t1", None)] == \
            [16, 16, 16, 0, 0]
    finally:
        eng.shutdown()


def test_unknown_adapter_fails_request_not_engine(pair):
    _, _, sd, _, ads = pair
    eng = _port(sd, max_slots=2, adapters=ads, **LORA)
    try:
        h = eng.submit(PROMPTS[0], 4, adapter="nope")
        with pytest.raises(AdapterLoadError, match="unknown adapter"):
            h.result(WAIT)
        got = eng.result(eng.submit(PROMPTS[1], 6, adapter="t0"), WAIT)
        np.testing.assert_array_equal(
            got, _port_oracle(sd, ads["t0"], PROMPTS[1], 6))
        assert eng.metrics()["rejected"] == 1
    finally:
        eng.shutdown()


def test_exhausted_pool_requeues_behind_live_streams(pair):
    """Three tenants, one pool row: the later tenants wait in the queue
    (decode never stalls) and finish with their oracle tokens; cold loads
    evict, and every row is released."""
    _, _, sd, _, ads = pair
    plan = [(PROMPTS[i], f"t{i}") for i in range(3)]
    eng = _port(sd, max_slots=3, paged=True, page_size=8, adapters=ads,
                **{**LORA, "adapter_slots": 1})
    pool = eng.adapter_pool
    got = _burst(eng, plan)
    for (p, a), g in zip(plan, got):
        np.testing.assert_array_equal(g, _port_oracle(sd, ads[a], p))
    st = pool.stats()
    assert st["referenced"] == 0 and st["loads"] == 3
    assert st["evictions"] == 2 and eng.metrics()["rejected"] == 0


def test_rows_release_on_retire_and_journal_records_adapter(pair, tmp_path):
    _, _, sd, _, ads = pair
    eng = _port(sd, max_slots=2, paged=True, page_size=8, kv_snapshot=True,
                snapshot_dir=str(tmp_path), adapters=ads, **LORA)
    try:
        h = eng.submit(PROMPTS[0], 6, adapter="t0")
        eng.result(h, WAIT)
        assert eng.adapter_pool.stats()["referenced"] == 0
        dig = eng.adapter_pool.resolve("t0")
        assert h.adapter_digest == dig and h._adapter_slot == 0
        # the pool archived its adapters into the engine's page store
        assert eng.snapshot.store.has(dig)
    finally:
        eng.shutdown()
    recs = [json.loads(line)
            for line in (tmp_path / "journal.jsonl").read_text().splitlines()]
    assert any(r.get("op") == "admit" and r["adapter"] == dig.hex()
               for r in recs)
    jpath = str(tmp_path / "unit-journal.jsonl")
    j = RequestJournal(jpath)
    j.admit(7, PROMPTS[0], 6, adapter=dig.hex())
    j.close()
    entries = RequestJournal.replay(jpath)
    assert entries[7]["adapter"] == dig.hex()
    (req,) = requests_from_journal(entries)
    assert req.adapter == dig.hex()


@pytest.mark.parametrize("mode", ["restart", "in_place"])
def test_recovery_restores_adapter_streams(pair, mode):
    """A step fault mid-decode with tenant streams in flight: recovered in
    place (the streams keep their rows) or, at ``max_recoveries=0``, by a
    supervisor restart (the resubmitted streams re-resolve under the new
    engine's pool). Every stream finishes with its oracle tokens."""
    _, _, sd, _, ads = pair
    plan = [(PROMPTS[0], None), (PROMPTS[1], "t0"), (PROMPTS[2], "t1"),
            (PROMPTS[3], "t0")]
    engines = []

    def factory():
        eng = _port(sd, max_slots=4, paged=True, page_size=8, adapters=ads,
                    max_recoveries=0 if mode == "restart" else 8, **LORA)
        engines.append(eng)
        return eng

    faults.configure("serving.step:error:after=2:times=1")
    sup = EngineSupervisor(factory, poll_interval_s=0.02,
                           backoff_base_s=0.01, backoff_max_s=0.05)
    try:
        hs = [sup.submit(p, 10, adapter=a) for p, a in plan]
        for (p, a), h in zip(plan, hs):
            np.testing.assert_array_equal(
                h.result(WAIT),
                _port_oracle(sd, None if a is None else ads[a], p, 10))
        assert faults.active_plan().counts() == {("serving.step", "error"): 1}
        assert sup.restarts == (1 if mode == "restart" else 0)
        last = engines[-1].metrics()
        assert last["adapter_referenced"] == 0
        if mode == "in_place":
            assert last["recoveries"] == 1
    finally:
        sup.close(drain=False)
        for eng in engines:
            eng.scheduler._thread.join(WAIT)


def test_adapter_load_faults_in_the_engine(pair):
    """``serving.adapter_load:corrupt`` once: the mangled copy is dropped
    and the stream's tokens do not change; ``:error`` once: that request
    fails with ``AdapterLoadError``, the others retire."""
    _, _, sd, _, ads = pair
    eng = _port(sd, max_slots=2, paged=True, page_size=8, adapters=ads,
                adapter_host_bytes=1 << 24, **{**LORA, "adapter_slots": 1})
    try:
        eng.result(eng.submit(PROMPTS[0], 4, adapter="t0"), WAIT)
        eng.result(eng.submit(PROMPTS[0], 4, adapter="t1"), WAIT)  # evicts t0
        faults.configure("seed=1;serving.adapter_load:corrupt:times=1")
        got = eng.result(eng.submit(PROMPTS[1], 6, adapter="t0"), WAIT)
        np.testing.assert_array_equal(
            got, _port_oracle(sd, ads["t0"], PROMPTS[1], 6))
        assert eng.metrics()["adapter_corrupt_dropped"] == 1
        faults.configure("serving.adapter_load:error:times=1")
        bad = eng.submit(PROMPTS[2], 4, adapter="t1")
        ok = eng.submit(PROMPTS[3], 4)
        with pytest.raises(AdapterLoadError, match="injected"):
            bad.result(WAIT)
        assert np.asarray(ok.result(WAIT)).size == 12 + 4
        met = eng.metrics()
        assert met["adapter_load_errors"] == 1 and met["rejected"] == 1
    finally:
        eng.shutdown()
