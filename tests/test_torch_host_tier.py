"""The port's host tier (``bigdl_tpu_torch/serving/host_tier.py`` and the
paged manager's demote/promote side) on the CPU, in the reference's cases
(``tests/test_host_tier.py``), with the reference's weights carried across
by ``convert``.

The seven ``TestHostPageTier`` unit cases; then, on the engine: eviction
demotes and a repeated prompt promotes, token-identical to the tier-off
engine on float32 and int8 pools (and, float32, to the reference's
sequential ``generate``); an exhaustion-preempted stream resumes from host
pages with the reference engine's ``prefix_miss_tokens`` (zero tokens
re-prefilled); speculation and tp 2 with the tier stay token-identical; a
corrupt host buffer degrades to re-prefill and, with a store attached, to
the store; a ``serving.host_swap`` fault drops swaps while streams
survive; ``PageStore.gc`` exempts the tier's pages. Copies are waited on
through the copier's ``close``, never by sleeping. Only the port's fault
plan is armed; an autouse fixture resets it.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bigdl_tpu.models.gpt import GPTForCausalLM as JaxGPT
from bigdl_tpu.serving import ServingEngine as JaxEngine
from bigdl_tpu_torch import convert
from bigdl_tpu_torch.models.gpt import GPTForCausalLM
from bigdl_tpu_torch.ops.paged_attention import paged_pool_attention
from bigdl_tpu_torch.resilience import faults
from bigdl_tpu_torch.serving import PagedSlotManager, ServingEngine
from bigdl_tpu_torch.serving.host_tier import (HostPageTier, HostTierCopier,
                                               PinnedStaging)
from bigdl_tpu_torch.serving.paging import _block_digest, chain_seed
from bigdl_tpu_torch.serving.snapshot import PageStore

CFG = dict(vocab_size=61, hidden_size=32, n_layers=2, n_heads=4,
           max_position=64)
WAIT = 120.0
# three 24-token prompts: at kv_pages=10 and page_size=8 each 36-token
# stream (24 + 12 new) holds 5 pages, so serving them one after another
# evicts, and the fourth request (A again) promotes
A = list(range(3, 3 + 24))
B = list(range(5, 5 + 24))
C = list(range(11, 11 + 24))


@pytest.fixture(autouse=True)
def _clean_port_plan():
    """No fault plan leaks across tests, and the process-wide kernel
    counters (``sharded_calls`` and the launch counts, which other files'
    tests read as this process's totals) are left as they were."""
    saved = (paged_pool_attention.sharded_calls,
             paged_pool_attention.launches,
             paged_pool_attention.int8_launches)
    faults.configure(None)
    yield
    faults.configure(None)
    (paged_pool_attention.sharded_calls, paged_pool_attention.launches,
     paged_pool_attention.int8_launches) = saved


def _weights(seed):
    jm = JaxGPT(**CFG)
    params, _ = jm.setup(jax.random.PRNGKey(seed), None)
    return jm, params, convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params))


def _sequential(jm, params, prompts, n_new):
    return [np.asarray(jm.generate(params, jnp.asarray(p, jnp.int32)[None],
                                   n_new))[0] for p in prompts]


def _tier_engine(sd, **kw):
    kw.setdefault("paged", True)
    kw.setdefault("max_queue", 32)
    kw.setdefault("max_slots", 2)
    kw.setdefault("page_size", 8)
    kw.setdefault("kv_pages", 10)
    kw.setdefault("prefill_chunk", 16)
    kw.setdefault("device", "cpu")
    return ServingEngine(GPTForCausalLM(**CFG, device="cpu"), sd, **kw)


def _run_serial(eng, prompts, n_new=12):
    """One request after another; with a tier, each request's demotions
    are resident before the next is submitted (the copier drained)."""
    outs = []
    for p in prompts:
        outs.append(np.asarray(eng.generate(p, n_new, timeout=WAIT)))
        if eng._host_copier is not None:
            eng._host_copier.drain()
    return outs


def _base_and_tier(sd, prompts=(A, B, C, A), **kw):
    """The tier-off engine's tokens, then the tier engine's with its
    metrics (read after the copier drained)."""
    eng = _tier_engine(sd, **kw)
    base = _run_serial(eng, prompts)
    eng.shutdown()
    eng = _tier_engine(sd, kv_host_tier=True, host_tier_prefetch=4, **kw)
    tier = _run_serial(eng, prompts)
    eng.shutdown()
    return base, tier, eng.metrics()


def _planes(nbytes=64, fill=1.0):
    return [{"k": np.full((2, nbytes // 16), fill, np.float32),
             "v": np.full((2, nbytes // 16), fill, np.float32)}]


# ------------------------------------------------------- tier unit tests
class TestHostPageTier:
    def test_stage_commit_get_roundtrip(self):
        tier = HostPageTier(1 << 20)
        eid = tier.stage([b"d0"], 64)
        assert eid is not None
        st = tier.stats()       # staged counts as in flight, not resident
        assert st["inflight_pages"] == 1 and st["resident_pages"] == 0
        assert tier.ingest(eid, _planes())
        st = tier.stats()
        assert st["inflight_pages"] == 0 and st["resident_pages"] == 1
        got = tier.get(b"d0")
        np.testing.assert_array_equal(got[0]["k"], _planes()[0]["k"])
        assert tier.stats()["hits"] == 1
        assert tier.get(b"nope") is None
        assert tier.stats()["misses"] == 1

    def test_budget_lru_eviction(self):
        tier = HostPageTier(3 * 64)
        for i in range(4):
            tier.ingest(tier.stage([b"d%d" % i], 64), _planes(fill=i))
        st = tier.stats()
        assert st["resident_bytes"] <= tier.budget_bytes
        assert st["evicted_pages"] == 1
        assert tier.get(b"d0") is None      # the oldest went first
        assert tier.get(b"d3") is not None
        assert tier.get(b"d1") is not None  # a hit refreshes LRU order
        tier.ingest(tier.stage([b"d9"], 64), _planes())
        assert tier.get(b"d1") is not None and tier.get(b"d2") is None

    def test_stage_dedups_resident_digests(self):
        tier = HostPageTier(1 << 20)
        tier.ingest(tier.stage([b"d0"], 64), _planes())
        assert tier.stage([b"d0"], 64) is None
        assert tier.stats()["skipped_pages"] == 1

    def test_oversized_and_abort_release_their_claims(self):
        tier = HostPageTier(100)
        assert tier.stage([b"big"], 101) is None
        tier.abort(tier.stage([b"d0"], 64))
        st = tier.stats()
        assert st["inflight_pages"] == 0 and st["inflight_bytes"] == 0
        assert tier.get(b"d0") is None

    def test_corrupt_buffer_dropped_on_get(self):
        tier = HostPageTier(1 << 20)
        tier.ingest(tier.stage([b"d0"], 64), _planes())
        entry = next(iter(tier._resident.values()))
        entry["planes"][0]["k"].view(np.uint8)[0] ^= 0xFF
        assert tier.get(b"d0") is None      # the checksum catches the flip
        st = tier.stats()
        assert st["corrupt_dropped"] == 1 and st["resident_pages"] == 0

    def test_copier_overlaps_and_drains(self):
        tier = HostPageTier(1 << 20)
        copier = HostTierCopier(tier)
        for i in range(8):
            copier.submit(tier.stage([b"d%d" % i], 64), _planes())
        copier.drain()
        st = tier.stats()
        assert st["resident_pages"] == 8 and st["inflight_pages"] == 0
        assert st["ingested_bytes"] == 8 * 64
        assert copier.close()

    def test_stats_never_double_count_mid_demotion(self):
        tier = HostPageTier(16 * 64)
        stop = threading.Event()
        errors = []

        def hammer():
            while not stop.is_set():
                st = tier.stats()
                try:
                    assert st["resident_bytes"] <= st["budget_bytes"]
                    assert st["inflight_pages"] >= 0
                    assert st["inflight_bytes"] >= 0
                    assert (st["resident_pages"] + st["evicted_pages"]
                            + st["corrupt_dropped"] == st["demoted_pages"])
                except AssertionError as e:     # pragma: no cover
                    errors.append(e)
                    return

        readers = [threading.Thread(target=hammer, daemon=True)
                   for _ in range(2)]
        for t in readers:
            t.start()
        copier = HostTierCopier(tier)
        try:
            for i in range(300):
                eid = tier.stage([b"x%d" % i], 64)
                if eid is not None:
                    copier.submit(eid, _planes())
        finally:
            assert copier.close()
            stop.set()
            for t in readers:
                t.join(timeout=10)
        assert errors == []
        assert tier.stats()["demoted_pages"] == 300


def test_pinned_staging_needs_the_card():
    """The pinned ring is the card's path (``PinnedStaging``); on the CPU
    the engine builds none and pages move by plain copies."""
    _, _, sd = _weights(31)
    eng = _tier_engine(sd, kv_host_tier=True)
    try:
        assert eng.host_staging is None and eng.slots.host_staging is None
        assert "host_tier_pinned_bytes" not in eng.metrics()
    finally:
        eng.shutdown()
    assert PinnedStaging.upload and PinnedStaging.download


# ------------------------------------------------ engine-level identity
@pytest.mark.parametrize("int8_kv", [False, True])
def test_demote_promote_token_identical(int8_kv):
    jm, params, sd = _weights(31)
    base, tier, met = _base_and_tier(sd, int8_kv=int8_kv)
    for e, g in zip(base, tier):
        np.testing.assert_array_equal(e, g)
    if not int8_kv:
        for g, w in zip(tier, _sequential(jm, params, [A, B, C, A], 12)):
            np.testing.assert_array_equal(g, w)
    assert met["host_tier_demoted_pages"] >= 1
    assert met["host_tier_hits"] >= 1
    assert met["host_tier_promoted_pages"] >= 1
    # int8 pools demote with their scale planes: 4 planes a layer
    assert met["kv_dtype"] == ("int8" if int8_kv else "float32")


def test_exhaustion_preemption_resumes_from_host_pages():
    """Concurrent streams exhaust the pool, the newest is preempted, its
    written pages demote through the tier, and its resume is a full prefix
    hit: ``prefix_miss_tokens`` is the reference engine's, the sum of the
    original prompts (zero tokens re-prefilled)."""
    jm, params, sd = _weights(32)
    prompts = [list(range(3, 3 + 20)), list(range(5, 5 + 20)),
               list(range(11, 11 + 20))]
    n_new = 16
    expected = _sequential(jm, params, prompts, n_new)
    # admit_wait_s holds admission until all three prompts queued, so
    # both engines batch alike whatever the load (the count depends on it)
    kw = dict(paged=True, max_queue=32, max_slots=3, page_size=8,
              kv_pages=9, prefill_chunk=32, kv_host_tier=True,
              host_tier_prefetch=4, admit_wait_s=0.5)
    jeng = JaxEngine(jm, params, **kw)
    try:
        for h in [jeng.submit(p, n_new) for p in prompts]:
            h.result(WAIT)
        jmet = jeng.metrics()
    finally:
        jeng.shutdown()
    eng = _tier_engine(sd, **kw)
    handles = [eng.submit(p, n_new) for p in prompts]
    results = [np.asarray(h.result(WAIT)) for h in handles]
    eng.shutdown()
    met = eng.metrics()
    for e, g in zip(expected, results):
        np.testing.assert_array_equal(e, g)
    assert met["preempted"] >= 1
    assert met["host_tier_promoted_pages"] >= 1
    assert met["prefix_miss_tokens"] == jmet["prefix_miss_tokens"] \
        == sum(len(p) for p in prompts)


def test_spec_decode_with_tier_token_identical():
    """``reserve_block`` over ``block_span`` may evict, and so demote, in
    the middle of a speculative iteration's reservation."""
    _, _, sd = _weights(33)
    base, tier, met = _base_and_tier(sd, spec_tokens=2)
    for e, g in zip(base, tier):
        np.testing.assert_array_equal(e, g)
    assert met["host_tier_demoted_pages"] >= 1


def test_tp2_with_tier_token_identical():
    """Demoted planes are full-H (the two shards' heads joined) and split
    again into each shard's pool on promotion: a tp 2 tier engine matches
    the tp 2 tier-off engine and the unsharded one."""
    _, _, sd = _weights(34)
    base, tier, met = _base_and_tier(sd, tp=2)
    flat, _, _ = _base_and_tier(sd)
    for e, g, f in zip(base, tier, flat):
        np.testing.assert_array_equal(e, g)
        np.testing.assert_array_equal(f, g)
    assert met["host_tier_demoted_pages"] >= 1
    assert met["host_tier_promoted_pages"] >= 1 and met["tp_degree"] == 2


def _corrupt_tier(eng):
    with eng.host_tier._lock:
        for entry in eng.host_tier._resident.values():
            for pl in entry["planes"]:
                next(iter(pl.values())).view(np.uint8)[0] ^= 0xFF


def _tier_only_prefix(eng, prompt):
    """The digests of ``prompt``'s full blocks that the pool no longer
    holds and the tier does: the copies its next admission must probe."""
    prev, out = chain_seed(), []
    a = np.asarray(prompt, np.int32)
    ps = eng.slots.page_size
    for b in range(a.size // ps):
        prev = _block_digest(prev, a[b * ps:(b + 1) * ps])
        if eng.slots.allocator.lookup(prev) is None \
                and eng.host_tier.has(prev):
            out.append(prev)
    return out


def test_corrupt_host_buffer_degrades_to_reprefill():
    """A's repeat must probe a corrupt tier copy: that is checked before
    the corruption, and the metrics are read with the engine still up,
    as the page-store sibling reads them."""
    _, _, sd = _weights(36)
    eng = _tier_engine(sd)
    base = _run_serial(eng, [A, B, C, A])
    eng.shutdown()
    eng = _tier_engine(sd, kv_host_tier=True, host_tier_prefetch=4)
    tier = _run_serial(eng, [A, B, C])
    assert eng.metrics()["host_tier_resident_pages"] >= 1
    assert _tier_only_prefix(eng, A)
    _corrupt_tier(eng)
    tier += _run_serial(eng, [A])
    met = eng.metrics()
    eng.shutdown()
    for e, g in zip(base, tier):
        np.testing.assert_array_equal(e, g)
    assert met["host_tier_corrupt_dropped"] >= 1


def test_corrupt_host_buffer_degrades_to_page_store(tmp_path):
    """With a store attached, corrupt host buffers fall through to the
    disk copy: the resume restores pages instead of re-prefilling."""
    _, _, sd = _weights(37)
    eng = _tier_engine(sd)
    base = _run_serial(eng, [A, B, C, A])
    eng.shutdown()
    eng = _tier_engine(sd, kv_snapshot=True, snapshot_dir=str(tmp_path),
                       snapshot_interval_s=0.0)
    _run_serial(eng, [A])
    eng.shutdown()
    eng = _tier_engine(sd, kv_snapshot=True, snapshot_dir=str(tmp_path),
                       snapshot_interval_s=0.0,
                       snapshot_journal="journal2.jsonl",
                       kv_host_tier=True, host_tier_prefetch=4)
    tier = _run_serial(eng, [A, B, C])
    restored_before = eng.slots.restored_pages
    assert restored_before >= 1          # the disk rung is reachable
    _corrupt_tier(eng)
    tier += _run_serial(eng, [A])
    met = eng.metrics()
    eng.shutdown()
    for e, g in zip(base, tier):
        np.testing.assert_array_equal(e, g)
    assert met["host_tier_corrupt_dropped"] >= 1
    assert met["restored_pages"] > restored_before


def test_host_swap_fault_drops_swaps_streams_survive():
    _, _, sd = _weights(38)
    eng = _tier_engine(sd)
    base = _run_serial(eng, [A, B, C, A])
    eng.shutdown()
    faults.configure("serving.host_swap:error:times=3")
    eng = _tier_engine(sd, kv_host_tier=True, host_tier_prefetch=4)
    tier = _run_serial(eng, [A, B, C, A])
    eng.shutdown()
    for e, g in zip(base, tier):
        np.testing.assert_array_equal(e, g)
    assert faults.active_plan().counts() == {("serving.host_swap",
                                              "error"): 3}


def test_page_store_gc_exempts_tier_resident(tmp_path):
    store = PageStore(str(tmp_path))
    digs = [b"g%d" % i for i in range(6)]
    store.put_batch([(d, _planes()) for d in digs])
    store.tier_resident = lambda: {digs[0].hex(), digs[1].hex()}
    assert store.gc(2) == 4
    assert store.get(digs[0]) is not None
    assert store.get(digs[1]) is not None
    assert store.get(digs[2]) is None


def test_snapshot_gc_pages_flag_and_tier_exemption(tmp_path, monkeypatch):
    _, _, sd = _weights(39)
    monkeypatch.setenv("BIGDL_TPU_KV_SNAPSHOT_GC_PAGES", "7")
    eng = _tier_engine(sd, kv_snapshot=True, snapshot_dir=str(tmp_path),
                       kv_host_tier=True)
    assert eng.snapshot.max_pages == 7
    assert eng.snapshot.store.tier_resident == eng.host_tier.hex_digests
    eng.shutdown()
    monkeypatch.delenv("BIGDL_TPU_KV_SNAPSHOT_GC_PAGES")
    eng = _tier_engine(sd, kv_snapshot=True, snapshot_dir=str(tmp_path),
                       snapshot_journal="journal2.jsonl")
    assert eng.snapshot.max_pages == 4 * eng.slots.num_pages
    assert eng.snapshot.store.tier_resident is None
    eng.shutdown()


def test_tier_flags_and_default_budget(monkeypatch):
    _, _, sd = _weights(40)
    monkeypatch.setenv("BIGDL_TPU_KV_HOST_TIER", "1")
    monkeypatch.setenv("BIGDL_TPU_KV_HOST_TIER_PREFETCH", "3")
    eng = _tier_engine(sd)
    try:
        # four pools' worth of full-H pages: 2 layers x K,V x 4 heads x 8
        # tokens x head_dim 8 x 4 bytes a page, 10 pages
        assert eng.host_tier.budget_bytes == 4 * 10 * 2 * 2 * 4 * 8 * 8 * 4
        assert eng.slots.host_tier_prefetch == 3
    finally:
        eng.shutdown()
    monkeypatch.setenv("BIGDL_TPU_KV_HOST_TIER_BYTES", "4096")
    eng = _tier_engine(sd)
    try:
        assert eng.host_tier.budget_bytes == 4096
    finally:
        eng.shutdown()


def test_flag_off_manager_paths_are_noops():
    _, _, sd = _weights(40)
    m = GPTForCausalLM(**CFG, device="cpu")
    m.load_state_dict(sd)
    pm = PagedSlotManager(m, max_slots=2, page_size=8, num_pages=10)
    assert pm.host_tier is None
    assert pm.preserve_stream([1, 2, 3], 0) == 0
    assert pm.prefetch_prefix([1, 2, 3], 8) == 0
    assert "host_tier_resident_pages" not in pm.pool_stats()


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8", "tp2",
                                  "tp2_int8"])
def test_page_roundtrip_through_host_planes(kind):
    """A page's host planes (the demote path's ``_page_buffer`` read back,
    and ``export_pages``) are its full-H planes, the shards' heads joined,
    bfloat16 as its bits; loading them into another page
    (``_dispatch_load``) reproduces every plane of every shard bit for
    bit."""
    import torch
    from bigdl_tpu_torch.serving.host_tier import DevicePage
    from bigdl_tpu_torch.serving.snapshot import _planes_checksum
    dtype = torch.bfloat16 if kind == "bfloat16" else torch.float32
    m = GPTForCausalLM(**CFG, device="cpu", dtype=dtype)
    if kind.startswith("tp2"):
        from bigdl_tpu_torch.parallel.layout import ModelLayout
        from bigdl_tpu_torch.parallel.tensor_parallel import \
            TensorParallelCausalLM
        m = TensorParallelCausalLM(m, ModelLayout(["cpu", "cpu"]))
    pm = PagedSlotManager(m, max_slots=2, page_size=8, num_pages=10,
                          int8_kv="int8" in kind)
    g = torch.Generator().manual_seed(0)
    shards = pm._shard_pools()
    for sh in shards:
        for pl in sh:
            for v in pl.values():
                v.copy_(torch.randint(-100, 100, v.shape, generator=g)
                        .to(v.dtype) if v.dtype == torch.int8
                        else torch.randn(v.shape, generator=g).to(v.dtype))
    host = DevicePage(*pm._page_buffer(3)).to_host()
    (_, exported), = pm.export_pages(extra=[(b"p3", 3)])
    assert _planes_checksum(host) == _planes_checksum(exported)
    assert pm._planes_compatible(host)
    for li, pl in enumerate(host):
        for k, a in pl.items():
            whole = torch.cat([sh[li][k][3] for sh in shards], 0)
            want = (whole.view(torch.int16).numpy().view(np.uint16)
                    if whole.dtype == torch.bfloat16 else whole.numpy())
            np.testing.assert_array_equal(a, want)
    pm._dispatch_load([7, 8], [host, exported])
    for sh in shards:
        for pl in sh:
            for v in pl.values():
                assert torch.equal(v[7], v[3]) and torch.equal(v[8], v[3])
