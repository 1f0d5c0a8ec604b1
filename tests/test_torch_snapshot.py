"""The port's snapshot store and request journal (``bigdl_tpu_torch/
serving/snapshot.py``) and restore-first recovery on the CPU, in the
reference's cases (``tests/test_snapshot.py``), with the reference's
weights carried across by ``convert``; greedy tokens equal the reference's
sequential ``generate``.

The ``PageStore`` and ``RequestJournal`` cases; ``chain_digests`` equal to
the port's prefix registry and to the reference's digests byte for byte,
and the page-file encoding and checksum equal to the reference's. A
restart over the same directory restores token-identically; a corrupt
store falls back to re-prefill; a store restores across tp degrees (1 and
2 on CPU shards); a supervised crash restores; the supervisor's wedge
grace covers a slow restore. Across packages: a store and journal written
by the reference's engine (its streams cut mid-generation) restore in the
port's engine token-identically with ``restored_pages > 0``, and the
reverse. The writer is waited on through ``flush``, never by sleeping.
Only the port's fault plan is armed; an autouse fixture resets it.
"""

import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bigdl_tpu.models.gpt import GPTForCausalLM as JaxGPT
from bigdl_tpu.serving import ServingEngine as JaxEngine
from bigdl_tpu.serving import snapshot as jsnap
from bigdl_tpu_torch import convert
from bigdl_tpu_torch.models.gpt import GPTForCausalLM
from bigdl_tpu_torch.ops.paged_attention import paged_pool_attention
from bigdl_tpu_torch.resilience import faults
from bigdl_tpu_torch.resilience.supervisor import EngineSupervisor
from bigdl_tpu_torch.serving import ServingEngine
from bigdl_tpu_torch.serving import snapshot as psnap
from bigdl_tpu_torch.serving.snapshot import (PageStore, RequestJournal,
                                              chain_digests,
                                              requests_from_journal)

CFG = dict(vocab_size=61, hidden_size=32, n_layers=2, n_heads=4,
           max_position=64)
WAIT = 120.0
PROMPTS8 = [[5, 9, 2, 17, 3], [1, 1, 4, 60, 8], [7, 3, 3],
            [9, 9, 9, 1, 0, 2, 4], [2, 4], [11, 12, 13, 14, 15, 16],
            [6, 6, 6, 6, 6, 7, 8, 9], [3, 1, 4, 1, 5, 9, 2, 6, 5]]
N_NEW = 10
SNAP = dict(max_slots=8, paged=True, kv_pages=32, page_size=4,
            prefill_chunk=4, kv_snapshot=True, snapshot_interval_s=0.0)


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


@pytest.fixture(scope="module")
def ref():
    """The reference model, its seed-0 weights (also as a port
    state_dict) and its sequential greedy tokens for PROMPTS8, N_NEW
    each."""
    jm = JaxGPT(**CFG)
    params, _ = jm.setup(jax.random.PRNGKey(0), None)
    want = [np.asarray(jm.generate(params, jnp.asarray(p, jnp.int32)[None],
                                   N_NEW))[0] for p in PROMPTS8]
    return jm, params, convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)), want


def _planes(seed, layers=2, heads=4, page=4, dim=8):
    rng = np.random.default_rng(seed)
    return [{"k": rng.standard_normal((heads, page, dim)).astype("float32"),
             "v": rng.standard_normal((heads, page, dim)).astype("float32")}
            for _ in range(layers)]


def _digest(i):
    return bytes([i]) * 16


def _snap_engine(sd, d, **kw):
    return ServingEngine(GPTForCausalLM(**CFG, device="cpu"), sd,
                         device="cpu", **{**SNAP, "snapshot_dir": str(d),
                                          **kw})


def _serve(eng, prompts, want, n_new=N_NEW):
    for h, w in zip([eng.submit(p, n_new) for p in prompts], want):
        np.testing.assert_array_equal(h.result(WAIT),
                                      w[:len(w) - N_NEW + n_new])


# ------------------------------------------------------------ page store
class TestPageStore:
    def test_roundtrip(self, tmp_path):
        store = PageStore(tmp_path)
        items = [(_digest(i), _planes(i)) for i in range(3)]
        assert store.put_batch(items) == 3
        assert len(store) == 3
        for dig, planes in items:
            assert store.has(dig)
            for a, b in zip(store.get(dig), planes):
                for k in b:
                    np.testing.assert_array_equal(a[k], b[k])
        assert store.pages_written == 3 and store.pages_restored == 3
        assert PageStore(tmp_path).digests() == {d for d, _ in items}

    def test_on_disk_corruption_demoted(self, tmp_path):
        store = PageStore(tmp_path)
        store.put_batch([(_digest(1), _planes(1))])
        (page_file,) = list((tmp_path / "pages").glob("*.page"))
        page_file.write_bytes(b"\x00" * 64)       # a torn write survived
        assert store.get(_digest(1)) is None
        assert store.corrupt_dropped == 1
        assert not store.has(_digest(1)) and not page_file.exists()

    def test_injected_write_corruption_demoted_on_read(self, tmp_path):
        faults.configure("serving.snapshot_write:corrupt=garbage:times=1")
        store = PageStore(tmp_path)
        store.put_batch([(_digest(1), _planes(1))])
        assert store.has(_digest(1))              # the rename won...
        assert store.get(_digest(1)) is None      # ...the checksum catches
        assert store.corrupt_dropped == 1

    def test_injected_write_error_skips_page(self, tmp_path):
        faults.configure("serving.snapshot_write:error:times=1")
        store = PageStore(tmp_path)
        assert store.put_batch([(_digest(1), _planes(1)),
                                (_digest(2), _planes(2))]) == 1
        assert store.write_errors == 1
        assert not store.has(_digest(1)) and store.has(_digest(2))

    def test_injected_restore_fault_is_a_miss(self, tmp_path):
        store = PageStore(tmp_path)
        store.put_batch([(_digest(1), _planes(1))])
        faults.configure("serving.snapshot_restore:error:times=1")
        assert store.get(_digest(1)) is None
        assert store.get(_digest(1)) is not None
        assert store.restore_misses == 1 and store.corrupt_dropped == 0

    def test_gc_respects_pins_and_recency(self, tmp_path):
        store = PageStore(tmp_path)
        store.put_batch([(_digest(i), _planes(i)) for i in range(6)])
        store.pin(7, [_digest(0)])                # oldest, but pinned
        assert store.gc(3) == 3 and len(store) == 3
        assert store.has(_digest(0))
        assert store.has(_digest(4)) and store.has(_digest(5))
        store.release(7)
        assert store.pinned_streams() == 0
        assert store.gc(1) == 2

    def test_torn_manifest_starts_empty(self, tmp_path):
        store = PageStore(tmp_path)
        store.put_batch([(_digest(1), _planes(1))])
        (tmp_path / "MANIFEST.json").write_text("{ torn")
        again = PageStore(tmp_path)
        assert len(again) == 0
        assert again.get(_digest(1)) is None


def test_page_files_are_the_references(tmp_path):
    """The same planes encode to the same page bytes and checksum in both
    packages, and a page written by either reads in the other."""
    planes = _planes(5)
    assert psnap._pack_planes(planes) == jsnap._pack_planes(planes)
    assert psnap._planes_checksum(planes) == jsnap._planes_checksum(planes)
    PageStore(tmp_path / "p").put_batch([(_digest(3), planes)])
    jsnap.PageStore(tmp_path / "j").put_batch([(_digest(4), planes)])
    for got in (jsnap.PageStore(tmp_path / "p").get(_digest(3)),
                PageStore(tmp_path / "j").get(_digest(4))):
        for a, b in zip(got, planes):
            for k in b:
                np.testing.assert_array_equal(a[k], b[k])


# --------------------------------------------------------------- journal
class TestRequestJournal:
    def test_admit_deliver_retire_replay(self, tmp_path):
        path = str(tmp_path / "journal.jsonl")
        j = RequestJournal(path)
        j.admit(1, [5, 9, 2], 8, temperature=0.0, eos_token=60)
        j.admit(2, [7, 3], 4)
        j.delivered(1, 0, [10, 11])
        j.delivered(1, 2, [12])
        j.retire(2)
        j.close()
        live = RequestJournal.replay(path)
        assert set(live) == {1}
        assert live[1]["prompt"] == [5, 9, 2]
        assert live[1]["tokens"] == [10, 11, 12]
        assert live[1]["eos"] == 60 and live[1]["max_new_tokens"] == 8
        assert jsnap.RequestJournal.replay(path) == live

    def test_replay_never_double_delivers(self, tmp_path):
        path = str(tmp_path / "journal.jsonl")
        recs = [{"op": "admit", "rid": 1, "prompt": [1], "max_new_tokens": 9,
                 "temperature": 0.0, "eos": None},
                {"op": "tok", "rid": 1, "off": 0, "toks": [10, 11]},
                {"op": "tok", "rid": 1, "off": 0, "toks": [10, 11]},  # dup
                {"op": "tok", "rid": 1, "off": 1, "toks": [11, 12]},  # lap
                {"op": "tok", "rid": 1, "off": 9, "toks": [99]}]      # gap
        with open(path, "w") as f:
            for r in recs:
                f.write(json.dumps(r) + "\n")
            f.write('{"op":"tok","rid":1,"off":3,"to')  # torn final line
        assert RequestJournal.replay(path)[1]["tokens"] == [10, 11, 12]

    def test_idempotent_admit(self, tmp_path):
        j = RequestJournal(str(tmp_path / "j.jsonl"))
        j.admit(1, [1, 2], 4)
        j.delivered(1, 0, [9])
        j.admit(1, [1, 2], 4)       # a recovery re-placement re-admits
        assert j.live()[1]["tokens"] == [9]
        j.close()

    def test_compaction_bounds_growth(self, tmp_path):
        j = RequestJournal(str(tmp_path / "j.jsonl"), compact_min=16)
        for rid in range(300):
            j.admit(rid, [1, 2, 3], 4)
            for off in range(4):
                j.delivered(rid, off, [off])
            j.retire(rid)
            assert j.record_count() <= 64
        assert j.compactions > 0 and not j.live()
        j.close()
        assert len(RequestJournal.replay(str(tmp_path / "j.jsonl"))) == 0

    def test_reopen_recovers_and_compacts(self, tmp_path):
        path = str(tmp_path / "j.jsonl")
        j = RequestJournal(path)
        j.admit(1, [1], 4)
        j.delivered(1, 0, [7, 8])
        j.admit(2, [2], 4)
        j.retire(2)
        j.close()
        j2 = RequestJournal(path)
        assert set(j2.live()) == {1}
        assert j2.live()[1]["tokens"] == [7, 8]
        assert j2.record_count() == 2
        j2.close()


def test_requests_from_journal_resume_at_the_offset():
    entries = {3: {"prompt": [1, 2], "max_new_tokens": 4,
                   "temperature": 0.0, "eos": None, "tokens": [7, 8]},
               4: {"prompt": [5], "max_new_tokens": 2, "temperature": 0.0,
                   "eos": None, "tokens": [1, 2]}}       # already done
    (r,) = requests_from_journal(entries)
    assert r.tokens == [7, 8] and r.context().tolist() == [1, 2, 7, 8]
    assert r.remaining() == 2


# ---------------------------------------------------------- digest match
def test_chain_digests_match_registry_and_reference(ref):
    _, _, sd, _ = ref
    prompt = [5, 9, 2, 17, 3, 1, 4, 8, 11]              # 2 full pages
    with ServingEngine(GPTForCausalLM(**CFG, device="cpu"), sd, device="cpu",
                       max_slots=2, paged=True, kv_pages=16, page_size=4,
                       prefill_chunk=4) as eng:
        eng.generate(prompt, 2, timeout=WAIT)
        registered = {d for d, _ in eng.slots.allocator.registered()}
    digs = chain_digests(prompt, 4)
    assert len(digs) == 2 and set(digs) <= registered
    assert digs == jsnap.chain_digests(prompt, 4)


# ---------------------------------------------------------- restore path
def test_requires_paged_and_dir(ref, tmp_path):
    _, _, sd, _ = ref
    m = GPTForCausalLM(**CFG, device="cpu")
    with pytest.raises(ValueError, match="paged"):
        ServingEngine(m, sd, device="cpu", kv_snapshot=True,
                      snapshot_dir=str(tmp_path))
    with pytest.raises(ValueError, match="directory"):
        ServingEngine(m, sd, device="cpu", paged=True, kv_pages=16,
                      kv_snapshot=True)


def test_restart_restores_token_identical(ref, tmp_path):
    _, _, sd, want = ref
    eng = _snap_engine(sd, tmp_path)
    try:
        _serve(eng, PROMPTS8, want)
    finally:
        assert eng.shutdown(drain=True)
    assert eng.snapshot.store.pages_written > 0
    assert not eng.snapshot.journal.live()       # all retired out
    eng2 = _snap_engine(sd, tmp_path)
    try:
        _serve(eng2, PROMPTS8, want)
        met = eng2.metrics()
    finally:
        eng2.shutdown(drain=False)
    assert met["restored_pages"] > 0
    assert met["snapshot_pages_restored"] > 0


def test_corrupt_store_falls_back_to_reprefill(ref, tmp_path):
    _, _, sd, want = ref
    eng = _snap_engine(sd, tmp_path)
    try:
        _serve(eng, PROMPTS8[:4], want, 8)
    finally:
        eng.shutdown(drain=True)
    for f in (tmp_path / "pages").glob("*.page"):
        f.write_bytes(b"junk")
    eng2 = _snap_engine(sd, tmp_path)
    try:
        _serve(eng2, PROMPTS8[:4], want, 8)
    finally:
        eng2.shutdown(drain=False)
    assert eng2.slots.restored_pages == 0
    assert eng2.snapshot.store.corrupt_dropped > 0


def test_snapshot_write_corruption_falls_back(ref, tmp_path):
    """``serving.snapshot_write:corrupt`` mangles every page file after its
    rename; the next engine demotes them and re-prefills, same tokens."""
    _, _, sd, want = ref
    faults.configure("serving.snapshot_write:corrupt")
    eng = _snap_engine(sd, tmp_path)
    try:
        _serve(eng, PROMPTS8[:4], want, 8)
    finally:
        eng.shutdown(drain=True)
    faults.configure(None)
    eng2 = _snap_engine(sd, tmp_path)
    try:
        _serve(eng2, PROMPTS8[:4], want, 8)
    finally:
        eng2.shutdown(drain=False)
    assert eng2.slots.restored_pages == 0
    assert eng2.snapshot.store.corrupt_dropped > 0


@pytest.mark.parametrize("tp_write,tp_read", [(2, 1), (1, 2)])
def test_restore_across_tp_degrees(ref, tmp_path, tp_write, tp_read):
    """Pages are full-H on disk: written at tp 2 they restore at tp 1 and
    the reverse, token-identical."""
    _, _, sd, want = ref
    eng = _snap_engine(sd, tmp_path, tp=tp_write)
    try:
        _serve(eng, PROMPTS8[:4], want, 8)
    finally:
        assert eng.shutdown(drain=True)
    assert eng.snapshot.store.pages_written > 0
    eng2 = _snap_engine(sd, tmp_path, tp=tp_read)
    try:
        _serve(eng2, PROMPTS8[:4], want, 8)
    finally:
        eng2.shutdown(drain=False)
    assert eng2.slots.restored_pages > 0


def test_journal_and_store_stay_bounded(ref, tmp_path):
    _, _, sd, _ = ref
    eng = _snap_engine(sd, tmp_path, max_slots=4, kv_pages=24)
    eng.snapshot.max_pages = 16
    eng.snapshot.journal.compact_min = 16
    try:
        for i in range(6):
            prompts = [[(i * 7 + j * 3 + k) % 61 for k in range(5 + j)]
                       for j in range(4)]
            for h in [eng.submit(p, 6) for p in prompts]:
                h.result(WAIT)
        eng.submit([1] * 40, 23).result(WAIT)
        assert eng.snapshot.flush()
        j = eng.snapshot.journal
        assert not j.live()
        assert j.record_count() <= 2 * j.compact_min
        assert eng.snapshot.store.pinned_streams() == 0
    finally:
        eng.shutdown(drain=True)
    assert len(eng.snapshot.store) <= 16


# ------------------------------------------------------------ supervisor
def _supervised_snap(sd, d, **kw):
    def factory():
        return _snap_engine(sd, d, max_recoveries=0)

    kw.setdefault("poll_interval_s", 0.02)
    kw.setdefault("backoff_base_s", 0.01)
    kw.setdefault("backoff_max_s", 0.05)
    return EngineSupervisor(factory, **kw)


def test_supervised_crash_restores_token_identical(ref, tmp_path):
    _, _, sd, want = ref
    sup = _supervised_snap(sd, tmp_path)
    try:
        _serve(sup, PROMPTS8, want)         # fills the store
        assert sup.engine.snapshot.store.pages_written > 0
        faults.configure("serving.step:error:after=3:times=1")
        _serve(sup, PROMPTS8, want)
        assert sup.restarts == 1
        assert sup.engine.slots.restored_pages > 0
    finally:
        sup.close(drain=False)


@pytest.mark.parametrize("grace", [30.0, 0.0])
def test_wedge_grace_during_restore(ref, tmp_path, grace):
    """A slow restore inside the wedge window is busy but healthy: with
    ``restore_grace_s`` the supervisor waits it out, without it the same
    delay is a wedge and the engine restarts."""
    _, _, sd, _ = ref
    sup = _supervised_snap(sd, tmp_path, wedge_timeout_s=0.5,
                           warmup_grace_s=20.0, restore_grace_s=grace)
    first = sup.engine
    try:
        sup.generate(PROMPTS8[0], 2, timeout=WAIT)
        faults.configure("serving.snapshot_restore:delay=2.0:times=1")
        assert sup.generate(PROMPTS8[7], 2, timeout=WAIT).size == 11
        assert (sup.restarts == 0) == bool(grace)
    finally:
        sup.close(drain=False)
    first.scheduler._thread.join(WAIT)     # no thread outlives the test


def test_no_wedge_in_the_window_after_a_restore(ref, tmp_path):
    """The end of a restore is progress. A slow page allocation right
    after a long restore (the store probe of the admission's prefix,
    ``serving.snapshot_restore:delay``, then ``serving.page_alloc:delay``
    in the same admission, before the loop's next heartbeat) lands in the
    window where the restore's grace is over and the heartbeat still dates
    from before the restore: with the grace on, the supervisor must not
    read that as a wedge (it did, whenever a poll landed there)."""
    _, _, sd, _ = ref
    sup = _supervised_snap(sd, tmp_path, wedge_timeout_s=0.5,
                           warmup_grace_s=20.0, restore_grace_s=30.0)
    first = sup.engine
    try:
        sup.generate(PROMPTS8[0], 2, timeout=WAIT)
        faults.configure("serving.snapshot_restore:delay=1.5:times=1;"
                         "serving.page_alloc:delay=0.3:times=1")
        assert sup.generate(PROMPTS8[7], 2, timeout=WAIT).size == 11
        fired = {site: n for site, n in faults.active_plan().counts()
                 .items() if n}
        assert sup.restarts == 0, fired
    finally:
        sup.close(drain=False)
    first.scheduler._thread.join(WAIT)
    assert fired == {("serving.snapshot_restore", "delay"): 1,
                     ("serving.page_alloc", "delay"): 1}


# --------------------------------------------------------- across packages
def _slow_steps(monkeypatch, obj, attr):
    real = getattr(obj, attr)

    def slow(*a, **k):
        time.sleep(0.02)
        return real(*a, **k)

    monkeypatch.setattr(obj, attr, slow)


def _cut_mid_stream(eng, prompts, n_new):
    """Serve ``prompts`` until every stream has 2..n_new-1 tokens, then
    abandon the loop (the journal keeps the streams live) and shut the
    engine down (the store is flushed)."""
    handles = [eng.submit(p, n_new) for p in prompts]
    deadline = time.monotonic() + WAIT
    while min(len(h.tokens) for h in handles) < 2:
        assert time.monotonic() < deadline
        time.sleep(0.002)
    eng.scheduler.abandon()
    eng.scheduler._thread.join(WAIT)
    eng.shutdown(drain=False)
    assert all(not h.done.is_set() and len(h.tokens) < n_new
               for h in handles)


def test_reference_store_restores_in_the_port(ref, tmp_path, monkeypatch):
    jm, params, sd, want = ref
    prompts = PROMPTS8[:4]
    jeng = JaxEngine(jm, params, **SNAP, snapshot_dir=str(tmp_path))
    _slow_steps(monkeypatch, jeng.slots, "step")
    _cut_mid_stream(jeng, prompts, N_NEW)
    live = RequestJournal.replay(str(tmp_path / "journal.jsonl"))
    resumed = requests_from_journal(live)
    assert len(resumed) == len(prompts)
    eng = _snap_engine(sd, tmp_path, snapshot_journal="port.jsonl")
    try:
        for r in resumed:
            eng.resubmit(r)
        for r in resumed:
            i = prompts.index(r.prompt.tolist())
            np.testing.assert_array_equal(r.result(WAIT), want[i])
        assert eng.slots.restored_pages > 0
    finally:
        eng.shutdown(drain=False)


def test_port_store_restores_in_the_reference(ref, tmp_path, monkeypatch):
    jm, params, sd, want = ref
    prompts = PROMPTS8[4:]
    eng = _snap_engine(sd, tmp_path)
    _slow_steps(monkeypatch, eng.slots, "step")
    _cut_mid_stream(eng, prompts, N_NEW)
    live = jsnap.RequestJournal.replay(str(tmp_path / "journal.jsonl"))
    resumed = jsnap.requests_from_journal(live)
    assert len(resumed) == len(prompts)
    jeng = JaxEngine(jm, params, **SNAP, snapshot_dir=str(tmp_path),
                     snapshot_journal="ref.jsonl")
    try:
        for r in resumed:
            jeng.resubmit(r)
        for r in resumed:
            i = prompts.index(r.prompt.tolist())
            np.testing.assert_array_equal(r.result(WAIT), want[4 + i])
        assert jeng.slots.restored_pages > 0
    finally:
        jeng.shutdown(drain=False)


def test_snapshot_writer_threads_stop(ref, tmp_path):
    _, _, sd, _ = ref
    before = {t.name for t in threading.enumerate()}
    eng = _snap_engine(sd, tmp_path)
    eng.generate(PROMPTS8[0], 2, timeout=WAIT)
    eng.shutdown()
    assert eng.snapshot.flush()
    assert {t.name for t in threading.enumerate()} <= before
