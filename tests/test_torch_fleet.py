"""The port's engine fleet (``bigdl_tpu_torch/serving/router.py``) against
the reference's (``bigdl_tpu/serving/router.py``), on the CPU.

The tiny GPT of the reference's ``tests/test_fleet.py`` (vocabulary 61,
hidden 32, 2 layers, 4 heads) with the reference's seeded weights
(``PRNGKey(0)``) through ``convert``. The reference's own fleet serves the
prompts once, flag off, for the greedy tokens every port fleet is held to.

- routing: ``route_digest`` returns the reference's bytes for prompts
  shorter than, equal to and longer than a block, with and without an
  adapter (a name, a raw 16-byte digest, its hex), and each prompt picks
  the reference's replica, by ``_Replica.score`` and through both fleets;
- flag off: no watcher thread, the newest replica retired, a replica
  retired between pick and submit retried once, ``load()`` surviving a
  replica mid-rebuild, the flags read from the environment;
- failover: eject, probation and readmission step for step as the
  reference's fleet; an evacuation mid-decode migrates the victim's
  streams, which finish with the reference fleet's tokens and no chunk
  delivered twice, at least one resuming from the shared ``PageStore``;
  a supervisor's ``victim_sink`` adopts what a tripped circuit would fail;
  a hedged interactive ``generate`` delivers once;
- ``requests_from_journal`` rebuilds the reference's handles;
- the ``AutoScaler`` over a real fleet scales up on a held backlog, and a
  scale-down with ``prefer_unhealthy`` retires the circuit-open replica;
- a retired or evacuated replica's engine (and its K/V pool) is freed;
- the ``bigdl_fleet_*`` families, labels and help strings are the
  reference's.
"""

import gc
import threading
import time
import weakref

import jax
import numpy as np
import pytest

from bigdl_tpu.models.gpt import GPTForCausalLM as JaxGPT
from bigdl_tpu.obs import metrics as jmetrics
from bigdl_tpu.resilience import faults as jfaults
from bigdl_tpu.resilience import preempt as jpreempt
from bigdl_tpu.serving import EngineFleet as JaxFleet
from bigdl_tpu.serving import ServingEngine as JaxEngine
from bigdl_tpu.serving import router as jrouter
from bigdl_tpu.serving.snapshot import \
    requests_from_journal as jax_requests_from_journal
from bigdl_tpu_torch import convert
from bigdl_tpu_torch.models.gpt import GPTForCausalLM
from bigdl_tpu_torch.obs.metrics import default_registry
from bigdl_tpu_torch.resilience import faults, preempt
from bigdl_tpu_torch.resilience.supervisor import EngineSupervisor
from bigdl_tpu_torch.serving import (AutoScaler, EngineFleet, ServingEngine,
                                     SlotManager)
from bigdl_tpu_torch.serving import router
from bigdl_tpu_torch.serving.router import (HEALTH_EJECTED, HEALTH_OK,
                                            HEALTH_PROBATION,
                                            make_tp_factory)
from bigdl_tpu_torch.serving.snapshot import requests_from_journal

CFG = dict(vocab_size=61, hidden_size=32, n_layers=2, n_heads=4,
           max_position=64)
PROMPTS = [[5, 9, 2, 17, 3], [1, 1, 4, 60, 8], [7, 3, 3],
           [9, 9, 9, 1, 0, 2, 4], [2, 4], [11, 12, 13, 14, 15, 16]]
N_NEW = 32
WAIT = 120.0


@pytest.fixture(autouse=True)
def _clean_harness():
    for f, p in ((faults, preempt), (jfaults, jpreempt)):
        f.configure(None)
        p.clear()
    yield
    for f, p in ((faults, preempt), (jfaults, jpreempt)):
        f.configure(None)
        p.clear()
        p.uninstall()


@pytest.fixture(scope="module")
def pair():
    """The reference model and weights, the port's state dict, and the
    reference fleet's greedy tokens of PROMPTS (flag off, 2 replicas)."""
    jm = JaxGPT(**CFG)
    params, _ = jm.setup(jax.random.PRNGKey(0), None)
    sd = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    fleet = JaxFleet(lambda: JaxEngine(jm, params, max_slots=4), replicas=2)
    try:
        hs = [fleet.submit(p, N_NEW) for p in PROMPTS]
        want = [np.asarray(h.result(WAIT)) for h in hs]
    finally:
        fleet.close(drain=False)
    return jm, params, sd, want


def _model():
    return GPTForCausalLM(**CFG, device="cpu")


def _dense_factory(sd):
    return lambda: ServingEngine(_model(), sd, device="cpu", max_slots=4)


def _snap_factory(sd, root):
    """Paged, snapshotting replicas over one shared PageStore directory,
    one journal each, through ``make_tp_factory`` on a repeated device
    (a mesh of one device each). 8 slots: every stream of a replica is in
    flight at once, so an evacuation catches them all mid-decode."""
    model = _model()

    def factory(replica_id=0):
        return make_tp_factory(
            model, sd, tp=1, devices=["cpu", "cpu", "cpu"], max_slots=8,
            paged=True, page_size=4, kv_pages=96, prefix_cache=True,
            kv_snapshot=True, snapshot_dir=str(root),
            snapshot_interval_s=0.02,
            snapshot_journal=f"journal-{replica_id}.jsonl")(replica_id)
    return factory


def _wait_until(cond, deadline, what):
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting: {what}"
        time.sleep(0.005)


# ----------------------------------------------------------------- routing
@pytest.mark.parametrize("route_block", [4, 16])
@pytest.mark.parametrize("length", [3, 16, 40])
@pytest.mark.parametrize("adapter", [None, "tenant-a", "raw", "hex"])
def test_route_digest_equals_the_reference_bytes(route_block, length,
                                                 adapter):
    rng = np.random.default_rng(length)
    prompt = rng.integers(0, 61, length).tolist()
    digest = bytes(range(16))
    ref = {None: None, "tenant-a": "tenant-a", "raw": digest,
           "hex": digest.hex()}[adapter]
    assert router._adapter_key(ref) == jrouter._adapter_key(ref)
    got = router.route_digest(prompt, route_block, adapter=ref)
    assert got == jrouter.route_digest(prompt, route_block, adapter=ref)
    assert isinstance(got, bytes) and len(got) == 16


def test_rendezvous_scores_pick_the_reference_replica():
    rng = np.random.default_rng(0)
    reps = [router._Replica(rid, None) for rid in range(5)]
    jreps = [jrouter._Replica(rid, None) for rid in range(5)]
    for _ in range(200):
        p = rng.integers(0, 61, int(rng.integers(1, 40))).tolist()
        d = router.route_digest(p, 16)
        assert [r.score(d) for r in reps] == [r.score(d) for r in jreps]
        # any live subset picks alike: adding or retiring a replica only
        # remaps the keys that replica owns
        for live in (reps[:2], reps[1:4], reps):
            jlive = [jreps[r.rid] for r in live]
            assert max(live, key=lambda r: r.score(d)).rid == \
                max(jlive, key=lambda r: r.score(d)).rid


def test_fleets_pick_alike_and_serve_the_reference_tokens(pair):
    jm, params, sd, want = pair
    jfleet = JaxFleet(lambda: JaxEngine(jm, params, max_slots=4),
                      replicas=3, route_block=4)
    fleet = EngineFleet(_dense_factory(sd), replicas=3, route_block=4)
    try:
        rng = np.random.default_rng(1)
        for _ in range(50):
            p = rng.integers(0, 61, int(rng.integers(1, 30))).tolist()
            for adapter in (None, "t0"):
                assert fleet._pick(p, adapter=adapter).rid == \
                    jfleet._pick(p, adapter=adapter).rid
        hs = [fleet.submit(p, N_NEW) for p in PROMPTS]
        for h, w in zip(hs, want):
            np.testing.assert_array_equal(np.asarray(h.result(WAIT)), w)
        assert sum(m["retired"] for m in fleet.metrics().values()) == 6
    finally:
        jfleet.close(drain=False)
        fleet.close(drain=False)


# ---------------------------------------------------------------- flag off
def test_flag_off_no_watcher_and_newest_retired(pair):
    fleet = EngineFleet(_dense_factory(pair[2]), replicas=2)
    try:
        assert fleet._failover is False and fleet._watcher is None
        assert not any(t.name == "bigdl-tpu-torch-fleet-health"
                       for t in threading.enumerate())
        assert fleet._replicas[0].sup.victim_sink is None
        newest = fleet._replicas[-1].rid
        assert fleet.remove_replica() == newest
        assert fleet.replica_count() == 1
        assert fleet.remove_replica() is None          # never below one
    finally:
        fleet.close(drain=False)


def test_submit_retries_a_replica_retired_between_pick_and_submit(pair):
    fleet = EngineFleet(_dense_factory(pair[2]), replicas=2)
    try:
        dead = fleet._replicas[-1]
        with fleet._lock:
            fleet._replicas = tuple(r for r in fleet._replicas
                                    if r is not dead)
        dead.sup.close(drain=False)
        real_pick, state = fleet._pick, {"stale": True}

        def pick(prompt, exclude=(), adapter=None):
            if state["stale"]:            # the race: a stale tuple read
                state["stale"] = False
                return dead
            return real_pick(prompt, exclude, adapter=adapter)

        fleet._pick = pick
        got = fleet.submit(PROMPTS[0], 6).result(WAIT)
        np.testing.assert_array_equal(np.asarray(got),
                                      pair[3][0][:len(PROMPTS[0]) + 6])
        assert state["stale"] is False
    finally:
        fleet.close(drain=False)


def test_load_survives_a_replica_mid_rebuild(pair):
    class _Boom:
        @property
        def scheduler(self):
            raise RuntimeError("mid-rebuild: scheduler torn down")

    fleet = EngineFleet(_dense_factory(pair[2]), replicas=2)
    rep = fleet._replicas[0]
    real = rep.sup.engine
    try:
        rep.sup.engine = _Boom()
        out = fleet.load()
        assert out["replicas"] == 2 and out["queue_depth"] >= 0
        assert 0.0 <= out["occupancy"] <= 1.0
        assert set(out) == {"queue_depth", "occupancy", "page_occupancy",
                            "ttft_p90", "ttft_sum", "ttft_count",
                            "replicas"}
    finally:
        rep.sup.engine = real
        fleet.close(drain=False)


def test_flags_from_env(pair, monkeypatch):
    monkeypatch.setenv("BIGDL_TPU_FLEET_FAILOVER", "1")
    monkeypatch.setenv("BIGDL_TPU_FLEET_EJECT_FAILURES", "5")
    monkeypatch.setenv("BIGDL_TPU_FLEET_HEDGE_S", "0.25")
    fleet = EngineFleet(_dense_factory(pair[2]), replicas=1)
    try:
        assert fleet._failover is True
        assert fleet.eject_failures == 5 and fleet.hedge_s == 0.25
        assert fleet._watcher is not None and fleet._watcher.is_alive()
        assert fleet._replicas[0].sup.victim_sink is not None
    finally:
        fleet.close(drain=False)


# ---------------------------------------------- eject / probation / canary
@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_eject_probation_readmit_cycle(pair, pkg):
    """The reference's cycle, run on both fleets: two submit failures
    eject, the watcher opens probation, two canary successes readmit, a
    probation failure re-ejects at once."""
    jm, params, sd, _ = pair
    cls, fac = ((JaxFleet, lambda: JaxEngine(jm, params, max_slots=4))
                if pkg == "reference" else (EngineFleet, _dense_factory(sd)))
    fleet = cls(fac, replicas=2, failover=True, eject_failures=2,
                probation_s=0.1, canary_successes=2, canary_every=1,
                health_poll_s=0.02, rebuild_budget_s=60.0)
    try:
        rep, other = fleet._replicas
        deadline = time.monotonic() + WAIT
        fleet._note_submit(rep, False)
        assert fleet.health()[rep.rid] == HEALTH_OK
        fleet._note_submit(rep, False)
        assert fleet.health()[rep.rid] == HEALTH_EJECTED
        assert fleet.ejections == 1
        assert all(fleet._pick(p).rid == other.rid for p in PROMPTS)
        _wait_until(lambda: fleet.health()[rep.rid] == HEALTH_PROBATION,
                    deadline, "probation window")
        fleet._note_submit(rep, True)
        fleet._note_submit(rep, True)
        assert fleet.health()[rep.rid] == HEALTH_OK
        assert fleet.readmissions == 1
        fleet._note_submit(rep, False)
        fleet._note_submit(rep, False)
        _wait_until(lambda: fleet.health()[rep.rid] == HEALTH_PROBATION,
                    deadline, "second probation window")
        fleet._note_submit(rep, False)
        assert fleet.health()[rep.rid] == HEALTH_EJECTED
        assert fleet.ejections == 3
    finally:
        fleet.close(drain=False)


# ------------------------------------------------------ migration, failover
def test_evacuation_migrates_streams_with_the_reference_tokens(pair,
                                                               tmp_path):
    """Evacuate the replica owning the most restorable prompts while its
    streams are mid-decode (decode paced by ``serving.step:delay``): every
    stream finishes with the reference fleet's tokens, none delivers a
    chunk twice, and at least one migrated stream restores its prefix
    pages from the shared store. The replica then comes back through
    probation, opened while the migrated streams still run, and is
    readmitted by canary traffic; its rebuilt engine never runs a stream
    that a survivor adopted."""
    sd, want = pair[2], pair[3]
    fleet = EngineFleet(_snap_factory(sd, tmp_path), replicas=3,
                        route_block=4, failover=True, probation_s=0.2,
                        canary_successes=1, canary_every=1,
                        rebuild_budget_s=60.0, health_poll_s=0.02,
                        supervisor_kw=dict(submit_wait_s=30.0))
    try:
        rid_of = [fleet._pick(p).rid for p in PROMPTS]
        counts = {}
        for rid, p in zip(rid_of, PROMPTS):
            if len(p) >= 4:
                counts[rid] = counts.get(rid, 0) + 1
        victim = max(counts, key=counts.get)
        assert counts[victim] >= 2
        faults.configure("serving.step:delay=0.02")
        handles = [fleet.submit(p, N_NEW) for p in PROMPTS]
        deadline = time.monotonic() + WAIT
        mine = [h for h, rid in zip(handles, rid_of) if rid == victim]
        _wait_until(lambda: all(len(h.tokens) >= 2 for h in mine),
                    deadline, "victim streams mid-decode")
        moved = fleet.evacuate_replica(victim)
        assert moved is not None and moved >= 2
        assert fleet.migrated_streams == moved
        assert fleet.health()[victim] == HEALTH_EJECTED
        assert all(fleet._pick(p).rid != victim for p in PROMPTS)
        for h, w in zip(handles, want):
            np.testing.assert_array_equal(np.asarray(h.result(WAIT)), w)
        for h, p, w in zip(handles, PROMPTS, want):
            assert [int(t) for t in h] == [int(t) for t in w[len(p):]]
        assert fleet.failover_restored >= 1
        assert (fleet.failover_restored + fleet.failover_reprefilled
                == fleet.migrated_streams)
        faults.configure(None)
        # probation: the watcher re-arms the circuit, the supervisor
        # rebuilds, one canary success readmits
        _wait_until(lambda: fleet.health()[victim] == HEALTH_PROBATION,
                    deadline, "probation window")
        rep = next(r for r in fleet._replicas if r.rid == victim)
        served = [fleet.submit(p, 4) for p in PROMPTS for _ in range(2)]
        for h in served:
            h.result(WAIT)
        assert fleet.health()[victim] == HEALTH_OK
        assert fleet.readmissions == 1 and rep.sup.restarts == 1
        # the rebuild adopted none of the streams the evacuation migrated
        # (a second ``abandon`` of the evacuated scheduler returns none)
        assert rep.sup.resubmitted == 0
    finally:
        fleet.close(drain=False)


def test_victim_sink_adopts_what_a_tripped_circuit_would_fail(pair,
                                                              monkeypatch):
    """A supervisor with no restart budget trips on the first failure of
    its engine's loop: with a ``victim_sink`` its unfinished requests go
    to the sink, unfinished, instead of failing with
    ``CircuitOpenError``."""
    sd = pair[2]
    got = []
    calls = {"n": 0}
    real = SlotManager._step

    def failing(*a, **k):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("injected dispatch fault")
        return real(*a, **k)

    monkeypatch.setattr(SlotManager, "_step", failing)
    sup = EngineSupervisor(
        lambda: ServingEngine(_model(), sd, device="cpu", max_slots=2,
                              max_recoveries=0),
        poll_interval_s=0.02, max_restarts=0)
    sup.victim_sink = lambda victims, err: got.append(
        ([v.done.is_set() for v in victims], type(err).__name__))
    try:
        h = sup.submit(PROMPTS[0], 20)
        deadline = time.monotonic() + WAIT
        _wait_until(lambda: got, deadline, "victims handed to the sink")
        assert got == [([False], "CircuitOpenError")]
        assert not h.done.is_set()
        assert sup.queue_depth() == 1 << 30 and sup.occupancy() == 1.0
    finally:
        sup.close(drain=False)


def test_hedged_generate_delivers_once(pair):
    """An interactive request stuck behind a home replica that stopped
    serving is hedged onto the other after ``hedge_s``: the winner's
    tokens come back, and the stuck loser is cancelled, never read."""
    sd, want = pair[2], pair[3]
    prompt = PROMPTS[0]

    class _Stuck:
        def __init__(self):
            self.done = threading.Event()
            self.error = None
            self.cancelled = False

        def cancel(self):
            self.cancelled = True
            self.done.set()

        def result(self, timeout=None):
            raise AssertionError("the hedge loser must never be read")

    fleet = EngineFleet(_dense_factory(sd), replicas=2, failover=True,
                        hedge_s=0.05, probation_s=60.0,
                        rebuild_budget_s=60.0, health_poll_s=0.2,
                        supervisor_kw=dict(poll_interval_s=60.0))
    try:
        home = fleet._pick(prompt)
        stuck = _Stuck()

        def crash_after_accept(*a, **kw):
            home.sup._serving.clear()
            return stuck

        home.sup.submit = crash_after_accept
        try:
            got = fleet.generate(prompt, 6, timeout=WAIT,
                                 priority="interactive")
        finally:
            home.sup._serving.set()
            del home.sup.submit
        np.testing.assert_array_equal(np.asarray(got),
                                      want[0][:len(prompt) + 6])
        assert fleet.hedges == 1 and stuck.cancelled is True
    finally:
        fleet.close(drain=False)


def test_requests_from_journal_rebuilds_the_reference_handles():
    entries = {
        3: {"prompt": [5, 6, 7], "max_new_tokens": 4,
            "tokens": [9, 8, 7, 6]},                 # at its budget
        4: {"prompt": [1, 2], "max_new_tokens": 8,
            "tokens": [3, 60], "eos": 60},           # EOS delivered
        5: {"prompt": [4, 4, 4], "max_new_tokens": 6,
            "tokens": [10, 11], "temperature": 0.0, "trace": "t-5"},
        6: {"prompt": [9], "max_new_tokens": 5, "tokens": []},
    }
    out = requests_from_journal(entries)
    ref = jax_requests_from_journal(entries)
    assert len(out) == len(ref) == 2
    for r, j in zip(out, ref):
        assert list(r.prompt) == list(j.prompt)
        assert r.tokens == j.tokens
        assert list(r.context()) == list(j.context())
        assert r.max_new_tokens == j.max_new_tokens
        assert r.trace == j.trace
        chunks = []
        while not r._stream.empty():
            chunks.append(r._stream.get_nowait())
        jchunks = []
        while not j._stream.empty():
            jchunks.append(j._stream.get_nowait())
        assert chunks == jchunks
    assert out[0].tokens == [10, 11] and out[1].tokens == []


# ------------------------------------------------------ scaling, lifecycle
def test_autoscaler_over_a_real_fleet(pair):
    """A backlog held by ``serving.step:delay`` votes the fleet up one
    replica; a scale-down preferring the unhealthy retires the
    evacuated replica, not the newest."""
    sd = pair[2]
    fleet = EngineFleet(
        lambda: ServingEngine(_model(), sd, device="cpu", max_slots=1),
        replicas=1)
    sc = AutoScaler(fleet, max_replicas=3, votes_to_scale=1, cooldown_s=0.0,
                    up_queue_depth=2.0)
    try:
        faults.configure("serving.step:delay=0.05")
        eng = fleet._replicas[0].sup.engine
        with eng.scheduler._cond:
            hs = [fleet.submit(p, 8) for p in PROMPTS]
        assert fleet.load()["queue_depth"] >= 3
        assert sc.step() == 1
        assert fleet.replica_count() == 2 and sc.scale_ups == 1
        faults.configure(None)
        for h in hs:
            h.result(WAIT)
        sick = fleet._replicas[0]
        sick.sup.evacuate()
        assert fleet.scale_to(1, prefer_unhealthy=True) == 1
        assert [r.rid for r in fleet._replicas] == [1]
        assert sc._scale_takes_pref is True
    finally:
        sc.stop()
        fleet.close(drain=False)


def test_retired_and_evacuated_replicas_free_their_engines(pair, tmp_path):
    """Nothing keeps a retired replica's engine, or an evacuated one's
    after its rebuild, alive: its slot manager (which holds the K/V
    pool) is collected."""
    sd = pair[2]
    fleet = EngineFleet(_snap_factory(sd, tmp_path), replicas=3,
                        failover=True, probation_s=0.05, canary_every=1,
                        canary_successes=1, rebuild_budget_s=60.0,
                        health_poll_s=0.02)
    try:
        for h in [fleet.submit(p, 4) for p in PROMPTS]:
            h.result(WAIT)
        rep = fleet._replicas[0]
        old = weakref.ref(rep.sup.engine.slots)
        fleet.evacuate_replica(rep.rid)
        deadline = time.monotonic() + WAIT
        _wait_until(lambda: rep.sup.restarts == 1
                    and rep.sup.state() == 0, deadline, "rebuild")
        newest = weakref.ref(fleet._replicas[-1].sup.engine.slots)
        assert fleet.remove_replica(prefer_unhealthy=False,
                                    migrate=False) == 2
        gc.collect()
        assert old() is None and newest() is None
    finally:
        fleet.close(drain=False)


def test_fleet_families_match_the_reference(pair):
    jm, params, sd, _ = pair
    fleets = [JaxFleet(lambda: JaxEngine(jm, params, max_slots=4),
                       replicas=1, failover=True, obs_label="parity"),
              EngineFleet(_dense_factory(sd), replicas=1, failover=True,
                          obs_label="parity")]
    try:
        snaps = [jmetrics.default_registry().snapshot(),
                 default_registry().snapshot()]
    finally:
        for f in fleets:
            f.close(drain=False)

    def families(snap):
        return {name: (fam["help"], fam["type"],
                       sorted({k for s in fam["series"]
                               for k in s["labels"]}))
                for name, fam in snap.items() if name.startswith("bigdl_fleet")
                and name not in ("bigdl_fleet_replicas",
                                 "bigdl_fleet_scale_ups_total",
                                 "bigdl_fleet_scale_downs_total")}

    ref, got = families(snaps[0]), families(snaps[1])
    assert set(ref) == {"bigdl_fleet_failover_streams_total",
                        "bigdl_fleet_ejected_total",
                        "bigdl_fleet_readmitted_total",
                        "bigdl_fleet_migrations_total",
                        "bigdl_fleet_hedges_total", "bigdl_fleet_health"}
    assert got == ref
