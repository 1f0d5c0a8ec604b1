"""Prefix-cache-aware routing over an autoscalable engine fleet (the port
of ``bigdl_tpu/serving/router.py``).

:class:`EngineFleet` runs R engine replicas, each behind its own
:class:`~bigdl_tpu_torch.resilience.supervisor.EngineSupervisor` (crash
detection, rebuild, token-identical resubmission), and routes each request
by rendezvous (highest-random-weight) hashing on the prompt's chained
block digests, the same blake2b chain the paged prefix cache keys its
pages by (``serving.paging``). Two prompts sharing a prefix of
``route_block``-aligned tokens hash to the same replica, so R replicas
behave as an R-way partitioned prefix cache; adding or retiring a replica
remaps only the keys that replica owns. The digests and the scores are
stdlib blake2b, so for the same replica ids each prompt and adapter picks
the reference's replica.

Skew guard: when the chosen replica's queue is both deep and markedly
deeper than the least-loaded one's, the request spills to the least-loaded
replica.

Failover (``BIGDL_TPU_FLEET_FAILOVER``, off): a health watcher tracks each
replica's circuit state, consecutive submit failures and how long it has
been rebuilding. An unhealthy replica is ejected from the ring and its
in-flight streams (live handles handed over by the supervisor's
``victim_sink``, plus strays rebuilt from the replica's
:class:`~bigdl_tpu_torch.serving.snapshot.RequestJournal`) are migrated:
resubmitted to survivors, which restore K/V pages from the shared
``PageStore`` and resume at the delivered offset, or re-prefill a stream
when the store misses. An ejected replica comes back through probation:
the circuit is re-armed, the supervisor rebuilds its engine, and every
``canary_every``-th pick routes canary traffic at it until
``canary_successes`` consecutive successes readmit it. With the flag off
none of this exists: no watcher thread, no health filtering, the same
routing.

On one card the replicas share the device (``make_tp_factory(...,
devices=[cuda:0, cuda:0])``), driven from one process: each replica's
scheduler thread, each supervisor's monitor and the fleet's watcher.

Thread model: the replica list is an immutable tuple, rebound under
``self._lock`` and read lock-free elsewhere; per-replica health fields are
mutated under the same lock. Supervisor calls (submit, close, evacuate)
happen outside the lock: they can block on an engine's build or drain.
"""

from __future__ import annotations

import functools
import hashlib
import inspect
import itertools
import logging
import threading
import time
import weakref

import numpy as np

from bigdl_tpu_torch import obs
from bigdl_tpu_torch.obs import reqtrace
from bigdl_tpu_torch.resilience.faults import FaultError, fault_point
from bigdl_tpu_torch.resilience.supervisor import (STATE_OPEN,
                                                   STATE_SERVING,
                                                   CircuitOpenError,
                                                   EngineSupervisor)
from bigdl_tpu_torch.serving.paging import _block_digest, chain_seed
from bigdl_tpu_torch.serving.scheduler import (EngineClosedError,
                                               EngineFailedError,
                                               QueueFullError)
from bigdl_tpu_torch.serving.snapshot import requests_from_journal
from bigdl_tpu_torch.utils.flags import get_flag

logger = logging.getLogger("bigdl_tpu_torch.serving.router")

# routing-health states (the bigdl_fleet_health gauge values)
HEALTH_OK = 0
HEALTH_PROBATION = 1
HEALTH_EJECTED = 2


def _adapter_key(ref):
    """Canonical routing bytes for an adapter reference: a 16-byte
    digest (raw or hex) keys by content, anything else by name. The
    router never resolves names — a name and its digest route
    independently, so a tenant should pick one form and stick to it."""
    if ref is None:
        return None
    if isinstance(ref, (bytes, bytearray)) and len(ref) == 16:
        return bytes(ref)
    s = str(ref)
    try:
        raw = bytes.fromhex(s)
    except ValueError:
        raw = None
    if raw is not None and len(raw) == 16:
        return raw
    return s.encode("utf-8")


def route_digest(prompt, route_block=16, adapter=None):
    """The routing key for ``prompt``: the chained block digest of its
    leading ``route_block``-aligned tokens (matching the prefix cache's
    chain), or a digest of the whole short prompt so sub-block prompts
    still route consistently. ``adapter`` seeds the chain with the same
    :func:`~bigdl_tpu_torch.serving.paging.chain_seed` domain separation the
    prefix cache uses, so the routing key equals the cache key: requests
    for the same (adapter, prefix) land on the replica whose pool holds
    that adapter warm AND whose cache holds those pages, while base
    requests (``adapter=None``) keep the historic key bit-identical."""
    a = np.asarray(prompt, np.int32).reshape(-1)
    n_full = a.size // route_block
    prev = chain_seed(_adapter_key(adapter))
    for b in range(n_full):
        prev = _block_digest(prev, a[b * route_block:(b + 1) * route_block])
    if n_full == 0:
        prev = _block_digest(prev, a)
    return prev


def make_tp_factory(model, params=None, tp=1, devices=None, **engine_kwargs):
    """Engine factory mapping each fleet replica onto its own disjoint
    ``tp``-device sub-slice.

    Replica ``r`` gets ``serving_mesh(tp, index=r % num_subslices(tp,
    devices), devices=devices)``: devices ``[r*tp, (r+1)*tp)`` of
    ``devices`` (default: the visible cards). A device may repeat, so
    ``devices=["cuda:0", "cuda:0"]`` puts two replicas on one card. Pass
    the result to :class:`EngineFleet` (or an ``EngineSupervisor``); the
    fleet sees the ``replica_id`` parameter and binds it per replica.
    Extra ``engine_kwargs`` (``paged=``, ``kv_bytes=``, a per-replica
    ``snapshot_journal=``...) go to every ``ServingEngine``."""

    def factory(replica_id=0):
        from bigdl_tpu_torch.parallel.layout import (num_subslices,
                                                     serving_mesh)
        from bigdl_tpu_torch.serving.engine import ServingEngine
        n = max(1, num_subslices(tp, devices=devices))
        mesh = serving_mesh(tp, index=int(replica_id) % n, devices=devices)
        return ServingEngine(model, params=params, mesh=mesh,
                             **engine_kwargs)

    return factory


class _Replica:
    """One fleet member: a supervisor, the stable id rendezvous hashing
    scores against (stable while others come and go), and, with failover
    on, its routing health (mutated under the fleet lock)."""

    def __init__(self, rid, supervisor):
        self.rid = rid
        self.sup = supervisor
        self._hseed = b"replica:%d:" % rid
        self.health = HEALTH_OK
        self.submit_failures = 0        # consecutive, reset on success
        self.canary_ok = 0              # probation successes so far
        self.canary_gate = 0            # pick counter gating canaries
        self.unhealthy_since = None     # monotonic, first non-SERVING poll
        self.ejected_at = 0.0
        self.migrating = False          # an evacuation sweep is running

    def score(self, digest):
        h = hashlib.blake2b(self._hseed + digest, digest_size=8).digest()
        return int.from_bytes(h, "big")

    def queue_depth(self):
        return self.sup.queue_depth()

    def occupancy(self):
        return self.sup.occupancy()


class EngineFleet:
    """R supervised engine replicas behind one ``submit()`` facade.

    ``factory`` builds one ``ServingEngine`` per call (the same factory
    contract as :class:`EngineSupervisor`); a factory declaring
    a ``replica_id`` keyword receives the replica's id — the hook for
    giving fleet members distinct journal names over one shared
    snapshot directory (``ServingEngine(snapshot_journal=...)``).
    ``route_block`` should match the paged engines' ``page_size`` so
    routing keys align with prefix-cache page boundaries; the dense
    default (16) still gives stable prompt-affinity. ``spill_depth`` /
    ``spill_ratio`` bound the skew guard: spill to the least-loaded
    replica only when the home replica has more than ``spill_depth``
    queued AND more than ``spill_ratio`` times the minimum.

    Failover knobs (all inert unless ``failover`` resolves true):

    - ``failover``: enable health-aware routing + cross-replica stream
      migration (``BIGDL_TPU_FLEET_FAILOVER``, off).
    - ``eject_failures``: consecutive submit failures that eject a
      replica (``BIGDL_TPU_FLEET_EJECT_FAILURES``, 3).
    - ``hedge_s``: seconds an *interactive* ``generate`` waits on a
      non-serving home replica before racing a hedge copy on another
      (``BIGDL_TPU_FLEET_HEDGE_S``, 0 = off).
    - ``rebuild_budget_s``: a replica continuously not-SERVING longer
      than this is ejected and its streams migrated.
    - ``probation_s`` / ``canary_successes`` / ``canary_every``: the
      re-admission window — see module docstring.
    """

    _ids = itertools.count()

    def __init__(self, factory, replicas=1, route_block=16,
                 spill_depth=4, spill_ratio=2.0, supervisor_kw=None,
                 failover=None, eject_failures=None, hedge_s=None,
                 rebuild_budget_s=3.0, probation_s=1.0,
                 canary_successes=3, canary_every=4, health_poll_s=0.05,
                 obs_label=None):
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        self.factory = factory
        self.route_block = int(route_block)
        self.spill_depth = int(spill_depth)
        self.spill_ratio = float(spill_ratio)
        self.supervisor_kw = dict(supervisor_kw or {})
        if failover is None:
            failover = get_flag("BIGDL_TPU_FLEET_FAILOVER", False, bool)
        self._failover = bool(failover)
        if eject_failures is None:
            eject_failures = get_flag("BIGDL_TPU_FLEET_EJECT_FAILURES",
                                      3, int)
        self.eject_failures = max(1, int(eject_failures))
        if hedge_s is None:
            hedge_s = get_flag("BIGDL_TPU_FLEET_HEDGE_S", 0.0, float)
        self.hedge_s = max(0.0, float(hedge_s))
        self.rebuild_budget_s = float(rebuild_budget_s)
        self.probation_s = float(probation_s)
        self.canary_successes = max(1, int(canary_successes))
        self.canary_every = max(1, int(canary_every))
        self.health_poll_s = float(health_poll_s)
        self.obs_label = (str(next(EngineFleet._ids))
                          if obs_label is None else str(obs_label))
        # plain mirrors of the obs counters (tests, BIGDL_TPU_OBS off)
        self.ejections = 0
        self.readmissions = 0
        self.migrated_streams = 0
        self.failover_restored = 0
        self.failover_reprefilled = 0
        self.hedges = 0
        self._obs = {}
        self._health_family = None
        if self._failover:
            reg = obs.default_registry()
            e = self.obs_label
            streams = reg.counter(
                "bigdl_fleet_failover_streams_total",
                "streams migrated off dead/retiring replicas by resume "
                "mode: restore reused prefix K/V pages (shared cache or "
                "snapshot store), reprefill recomputed the context",
                ("fleet", "mode"))
            self._obs = {
                "failover_restore": streams.labels(e, "restore"),
                "failover_reprefill": streams.labels(e, "reprefill"),
                "ejected": reg.counter(
                    "bigdl_fleet_ejected_total",
                    "replicas ejected from the rendezvous ring",
                    ("fleet",)).labels(e),
                "readmitted": reg.counter(
                    "bigdl_fleet_readmitted_total",
                    "ejected replicas readmitted after probation "
                    "canaries", ("fleet",)).labels(e),
                "migrations": reg.counter(
                    "bigdl_fleet_migrations_total",
                    "stream migrations between replicas (failover and "
                    "migrating scale-down)", ("fleet",)).labels(e),
                "hedges": reg.counter(
                    "bigdl_fleet_hedges_total",
                    "hedged resubmissions of interactive requests stuck "
                    "behind a rebuilding replica", ("fleet",)).labels(e),
            }
            self._health_family = reg.gauge(
                "bigdl_fleet_health",
                "per-replica routing health: 0 healthy / 1 probation / "
                "2 ejected", ("fleet", "replica"))
        try:
            self._factory_takes_rid = (
                "replica_id" in inspect.signature(factory).parameters)
        except (TypeError, ValueError):
            self._factory_takes_rid = False
        self._lock = threading.Lock()
        self._rid = itertools.count()
        self._closed = False
        self._replicas = ()
        self._stop = threading.Event()
        self._watcher = None
        for _ in range(replicas):
            self.add_replica()
        if self._failover:
            self._watcher = threading.Thread(
                target=self._watch, name="bigdl-tpu-torch-fleet-health",
                daemon=True)
            self._watcher.start()
        # /healthz liveness probe (weakref: the registry must never
        # keep a dropped fleet alive)
        fref = weakref.ref(self)
        label = self.obs_label

        def _fleet_probe():
            fleet = fref()
            if fleet is None or fleet._closed:
                return None
            return {f"fleet:{label}:replica:{rid}": h != HEALTH_EJECTED
                    for rid, h in fleet.health().items()}

        self._health_probe = _fleet_probe
        obs.default_registry().register_probe(_fleet_probe)

    # ------------------------------------------------------------ scaling --
    def add_replica(self):
        """Build and publish one more replica; returns its id."""
        rid = next(self._rid)
        kw = dict(self.supervisor_kw)
        kw.setdefault("obs_label", f"fleet-{rid}")
        fac = self.factory
        if self._factory_takes_rid:
            fac = functools.partial(fac, replica_id=rid)
        rep = _Replica(rid, EngineSupervisor(fac, **kw))
        if self._failover:
            # attach before publishing — before any traffic can trip
            # the circuit — so victims are adopted, never failed
            rep.sup.victim_sink = functools.partial(
                self._on_replica_victims, rep)
            self._set_health_gauge(rep)
        with self._lock:
            if self._closed:
                pass
            else:
                self._replicas = self._replicas + (rep,)
                return rid
        rep.sup.close(drain=False)
        raise RuntimeError("fleet is closed")

    def remove_replica(self, drain=True, timeout=None,
                       prefer_unhealthy=None, migrate=None):
        """Retire one replica (new routes stop hitting it immediately).

        Legacy path (both defaults off — the pre-failover behavior):
        unpublish the NEWEST replica and close it, draining its
        in-flight requests. With ``prefer_unhealthy`` (defaults to the
        failover flag) the LEAST-HEALTHY replica is retired instead —
        ejected beats probation beats healthy, circuit-open beats
        serving, then most consecutive submit failures, then newest —
        so scale-down removes broken capacity first. With ``migrate``
        (same default) its live streams are migrated to the survivors
        instead of blocking this call on a drain. No-op at one replica;
        returns the retired id or None."""
        if prefer_unhealthy is None:
            prefer_unhealthy = self._failover
        if migrate is None:
            migrate = self._failover
        with self._lock:
            if len(self._replicas) <= 1:
                return None
            rep = (max(self._replicas, key=self._badness)
                   if prefer_unhealthy else self._replicas[-1])
            self._replicas = tuple(x for x in self._replicas
                                   if x is not rep)
        if migrate:
            logger.warning("fleet %s: retiring replica %d with live "
                           "migration", self.obs_label, rep.rid)
            self._evacuate_rep(rep, "migrating scale-down")
            rep.sup.close(drain=False, timeout=timeout)
        else:
            rep.sup.close(drain=drain, timeout=timeout)
        return rep.rid

    @staticmethod
    def _badness(rep):
        """Retirement preference order (most-retirable sorts highest)."""
        try:
            st = rep.sup.state()
        except Exception:
            st = STATE_OPEN
        return (rep.health, st, rep.submit_failures, rep.rid)

    def scale_to(self, n, drain=True, prefer_unhealthy=None):
        """Grow or shrink to ``n`` replicas (the AutoScaler hook)."""
        n = max(1, int(n))
        while self.replica_count() < n:
            self.add_replica()
        while self.replica_count() > n:
            if self.remove_replica(
                    drain=drain,
                    prefer_unhealthy=prefer_unhealthy) is None:
                break
        return self.replica_count()

    def replica_count(self):
        return len(self._replicas)

    # ------------------------------------------------------------ signals --
    def load(self):
        """Fleet-aggregate signals for the AutoScaler: total queue
        depth, mean occupancy, worst page occupancy, worst TTFT p90.
        Each replica is scraped best-effort: one wedged or mid-rebuild
        member (engine swapped out, scheduler torn down, slots
        half-built) must never break the control loop's poll."""
        reps = self._replicas
        depth, occ, page_occ, ttft = 0, 0.0, 0.0, None
        ttft_sum, ttft_count = 0.0, 0
        for rep in reps:
            try:
                depth += min(rep.queue_depth(), 1 << 20)
                occ += rep.occupancy()
                eng = rep.sup.engine
                if eng is None:
                    continue
                sch = eng.scheduler
                try:
                    st = sch.slots.pool_stats()
                    page_occ = max(page_occ, float(st["page_occupancy"]))
                except (AttributeError, KeyError):
                    pass
                hist = sch.ttft_histogram()
                if hist is not None and hist.count:
                    _, s, c = hist.snapshot()
                    ttft_sum += s
                    ttft_count += c
                    q = hist.quantile(0.9)
                    if q is not None:
                        ttft = q if ttft is None else max(ttft, q)
            except Exception:
                logger.debug("fleet %s: replica %d scrape failed "
                             "(mid-rebuild?)", self.obs_label, rep.rid,
                             exc_info=True)
                continue
        n = max(1, len(reps))
        return {"queue_depth": depth, "occupancy": occ / n,
                "page_occupancy": page_occ, "ttft_p90": ttft,
                "ttft_sum": ttft_sum, "ttft_count": ttft_count,
                "replicas": len(reps)}

    # ------------------------------------------------------------ routing --
    def _pick(self, prompt, exclude=(), adapter=None):
        reps = self._replicas
        if exclude:
            reps = tuple(r for r in reps if r.rid not in exclude)
        if not reps:
            raise QueueFullError("fleet has no replicas")
        if self._failover:
            reps = self._route_set(reps)
        if len(reps) == 1:
            return reps[0]
        digest = route_digest(prompt, self.route_block, adapter=adapter)
        home = max(reps, key=lambda rep: rep.score(digest))
        depth = home.queue_depth()
        if depth > self.spill_depth:
            cold = min(reps, key=lambda rep: rep.queue_depth())
            if (cold is not home
                    and depth > self.spill_ratio
                    * max(1, cold.queue_depth())):
                return cold
        return home

    def _route_set(self, reps):
        """The health-filtered rendezvous ring: healthy members plus
        any probation member whose canary gate opens on this pick.
        With EVERY candidate ejected, fall back to all of them — a
        real circuit-open error beats a synthetic reject."""
        with self._lock:
            ring = []
            for rep in reps:
                if rep.health == HEALTH_OK:
                    ring.append(rep)
                elif rep.health == HEALTH_PROBATION:
                    rep.canary_gate += 1
                    if rep.canary_gate % self.canary_every == 0:
                        ring.append(rep)
            return tuple(ring) or reps

    def submit(self, prompt, max_new_tokens, **kw):
        """Route and submit; returns the ``Request`` handle. Raises
        exactly what the routed supervisor's submit raises
        (``QueueFullError`` backpressure, ``CircuitOpenError``, typed
        admission rejections) — except that a replica retired (or,
        with failover on, ejected) between the pick and the submit is
        retried ONCE against the refreshed replica tuple instead of
        leaking its ``EngineClosedError`` to the caller."""
        if self._closed:
            raise QueueFullError("fleet is closed")
        # mint the trace HERE so the routing decision is its first span
        # (the engine reuses a caller-provided trace instead of minting)
        if kw.get("trace") is None and reqtrace.enabled():
            kw["trace"] = reqtrace.mint()
        rep = self._pick(prompt, adapter=kw.get("adapter"))
        reqtrace.event(kw.get("trace"), "route", fleet=self.obs_label,
                       replica=rep.rid)
        try:
            out = rep.sup.submit(prompt, max_new_tokens, **kw)
        except (CircuitOpenError, EngineClosedError):
            self._note_submit(rep, False)
            retry = self._retry_replica(prompt, rep,
                                        adapter=kw.get("adapter"))
            if retry is None:
                raise
            reqtrace.event(kw.get("trace"), "route", fleet=self.obs_label,
                           replica=retry.rid, retry=True)
            out = retry.sup.submit(prompt, max_new_tokens, **kw)
            self._note_submit(retry, True)
            return out
        self._note_submit(rep, True)
        return out

    def generate(self, prompt, max_new_tokens, timeout=None, **kw):
        if self._closed:
            raise QueueFullError("fleet is closed")
        rep = self._pick(prompt, adapter=kw.get("adapter"))
        if (self._failover and self.hedge_s > 0.0
                and kw.get("priority", "standard") == "interactive"):
            return self._generate_hedged(rep, prompt, max_new_tokens,
                                         timeout, kw)
        try:
            out = rep.sup.generate(prompt, max_new_tokens,
                                   timeout=timeout, **kw)
        except (CircuitOpenError, EngineClosedError):
            self._note_submit(rep, False)
            retry = self._retry_replica(prompt, rep,
                                        adapter=kw.get("adapter"))
            if retry is None:
                raise
            out = retry.sup.generate(prompt, max_new_tokens,
                                     timeout=timeout, **kw)
            self._note_submit(retry, True)
            return out
        self._note_submit(rep, True)
        return out

    def _retry_replica(self, prompt, failed, adapter=None):
        """One re-route after a submit failed underneath us: always
        when the picked replica was concurrently retired (it raised
        from a tuple we no longer publish), and — with failover on —
        whenever re-picking lands elsewhere (route around the
        unhealthy member). Returns the fresh replica, or None to
        re-raise the original error."""
        if failed in self._replicas and not self._failover:
            return None
        try:
            return self._pick(prompt, exclude=frozenset((failed.rid,)),
                              adapter=adapter)
        except QueueFullError:
            return None

    def _note_submit(self, rep, ok):
        """Per-replica submit-health accounting (failover only):
        consecutive failures eject; probation canary successes
        readmit; a probation canary failure re-ejects immediately."""
        if not self._failover:
            return
        ejected = readmitted = False
        with self._lock:
            if ok:
                rep.submit_failures = 0
                if rep.health == HEALTH_PROBATION:
                    rep.canary_ok += 1
                    if rep.canary_ok >= self.canary_successes:
                        readmitted = self._readmit_locked(rep)
            else:
                rep.submit_failures += 1
                if (rep.health == HEALTH_PROBATION
                        or rep.submit_failures >= self.eject_failures):
                    ejected = self._eject_locked(rep)
        if ejected:
            logger.warning("fleet %s: replica %d ejected after %d "
                           "consecutive submit failure(s)",
                           self.obs_label, rep.rid, rep.submit_failures)
        if readmitted:
            logger.warning("fleet %s: replica %d readmitted after %d "
                           "canary success(es)", self.obs_label,
                           rep.rid, self.canary_successes)

    # ----------------------------------------------------- hedged serving --
    def _generate_hedged(self, home, prompt, max_new_tokens, timeout, kw):
        """Hedge for interactive requests stuck behind a rebuilding
        home replica: submit to home; if nothing completed within
        ``hedge_s`` AND home is no longer SERVING, race a second copy
        on another replica. The first *successful* finisher wins and
        the loser is cancelled — only the winner's handle is ever
        read, so no token is double-delivered."""
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)

        def remaining():
            return (None if deadline is None
                    else max(0.0, deadline - time.monotonic()))

        h1 = home.sup.submit(prompt, max_new_tokens, **kw)
        self._note_submit(home, True)
        wait1 = self.hedge_s
        if deadline is not None:
            wait1 = min(wait1, max(0.0, deadline - time.monotonic()))
        if h1.done.wait(wait1):
            return h1.result(remaining())
        if home.sup.state() == STATE_SERVING:
            # slow but healthy: hedging would only double the load
            try:
                return h1.result(remaining())
            except TimeoutError:
                h1.cancel()
                raise
        h2 = None
        try:
            alt = self._pick(prompt, exclude=frozenset((home.rid,)),
                             adapter=kw.get("adapter"))
            h2 = alt.sup.submit(prompt, max_new_tokens, **kw)
        except Exception:
            logger.exception("fleet %s: hedge submit failed; staying "
                             "with the home replica", self.obs_label)
        if h2 is None:
            try:
                return h1.result(remaining())
            except TimeoutError:
                h1.cancel()
                raise
        with self._lock:
            self.hedges += 1
        c = self._obs.get("hedges")
        if c is not None:
            c.inc()
        while True:
            if h1.done.is_set() and h1.error is None:
                winner, loser = h1, h2
                break
            if h2.done.is_set() and h2.error is None:
                winner, loser = h2, h1
                break
            if h1.done.is_set() and h2.done.is_set():
                winner, loser = h1, h2   # both failed: surface home's
                break
            if deadline is not None and time.monotonic() >= deadline:
                h1.cancel()
                h2.cancel()
                raise TimeoutError(
                    f"request still in flight after {timeout}s (hedged)")
            h1.done.wait(0.005)
        loser.cancel()
        return winner.result(remaining())

    # ----------------------------------------------------- health watcher --
    def _watch(self):
        while not self._stop.wait(self.health_poll_s):
            try:
                self._health_pass()
            except Exception:
                logger.exception("fleet %s: health pass failed; "
                                 "continuing", self.obs_label)

    def _health_pass(self, now=None):
        """One health sweep over the published replicas: eject +
        evacuate dead/over-budget members, open the probation window
        for ejected ones. The ``fleet.failover`` fault site fires here
        per replica — an injected error declares that replica dead
        (the chaos rig's deterministic kill switch)."""
        now = time.monotonic() if now is None else float(now)
        for rep in self._replicas:
            injected = None
            try:
                fault_point("fleet.failover", replica=rep.rid)
            except FaultError as e:
                injected = e
            st = rep.sup.state()
            with self._lock:
                if st == STATE_SERVING:
                    rep.unhealthy_since = None
                elif rep.unhealthy_since is None:
                    rep.unhealthy_since = now
                health = rep.health
                since = rep.unhealthy_since
                ejected_at = rep.ejected_at
                migrating = rep.migrating
            if health != HEALTH_EJECTED:
                if injected is not None:
                    self.evacuate_replica(
                        rep.rid, reason=f"injected fault: {injected!r}")
                elif st == STATE_OPEN:
                    self.evacuate_replica(rep.rid, reason="circuit open")
                elif (since is not None
                      and now - since > self.rebuild_budget_s):
                    self.evacuate_replica(
                        rep.rid,
                        reason=(f"rebuild exceeded the "
                                f"{self.rebuild_budget_s:g}s budget"))
                continue
            if migrating or now - ejected_at < self.probation_s:
                continue
            if st == STATE_OPEN:
                # we (or the trip) hold the circuit open: re-arm it so
                # the supervisor rebuilds its engine; probation starts
                # once it is SERVING again
                rep.sup.reset_circuit()
            elif st == STATE_SERVING:
                with self._lock:
                    entered = rep.health == HEALTH_EJECTED
                    if entered:
                        rep.health = HEALTH_PROBATION
                        rep.canary_ok = 0
                        rep.canary_gate = 0
                        self._set_health_gauge(rep)
                if entered:
                    logger.warning("fleet %s: replica %d entering "
                                   "probation (canary traffic)",
                                   self.obs_label, rep.rid)

    # ---------------------------------------------------------- migration --
    def evacuate_replica(self, rid, reason="operator request"):
        """Cordon + migrate NOW: eject replica ``rid`` from the ring
        and move its unfinished streams to the survivors. The replica
        stays a fleet member — its supervisor sits circuit-open until
        the probation window re-arms it (or ``remove_replica`` retires
        it). Returns the number of streams migrated, or None when the
        rid is unknown or an evacuation is already running."""
        rep = next((r for r in self._replicas if r.rid == int(rid)), None)
        if rep is None:
            return None
        return self._evacuate_rep(rep, reason)

    def _evacuate_rep(self, rep, reason):
        with self._lock:
            if rep.migrating:
                return None
            rep.migrating = True
            ejected = self._eject_locked(rep)
        if ejected:
            logger.warning("fleet %s: evacuating replica %d (%s)",
                           self.obs_label, rep.rid, reason)
        try:
            victims = rep.sup.evacuate()
            victims = victims + self._journal_orphans(rep, victims)
            return self._migrate(victims, rep, reason)
        finally:
            with self._lock:
                rep.migrating = False

    def _on_replica_victims(self, rep, victims, error):
        """Supervisor victim sink (runs on that supervisor's monitor
        thread at circuit trip): eject the replica and adopt its
        victims onto the survivors. The journal-orphan sweep runs only
        when no evacuation is already collecting this replica — the
        handed victims themselves are always migrated (nothing else
        holds them)."""
        with self._lock:
            sweep = not rep.migrating
            rep.migrating = True
            self._eject_locked(rep)
        logger.warning("fleet %s: adopting %d victim(s) of replica %d "
                       "(%r)", self.obs_label, len(victims), rep.rid,
                       error)
        try:
            if sweep:
                victims = victims + self._journal_orphans(rep, victims)
            return self._migrate(victims, rep, f"circuit trip: {error!r}")
        finally:
            if sweep:
                with self._lock:
                    rep.migrating = False

    def _journal_orphans(self, rep, victims):
        """Journal backstop: streams recorded live on the replica's
        RequestJournal with no surviving handle among ``victims`` (a
        wedged loop can strand them) are reconstructed as fresh
        requests — delivered tokens pre-seeded, generation resuming at
        the journaled offset."""
        try:
            snap = getattr(rep.sup.engine, "snapshot", None)
            if snap is None:
                return []
            have = {r.id for r in victims}
            entries = {rid: e for rid, e in snap.journal.live().items()
                       if rid not in have}
            orphans = requests_from_journal(entries)
        except Exception:
            logger.exception("fleet %s: journal reconstruction for "
                             "replica %d failed", self.obs_label,
                             rep.rid)
            return []
        if orphans:
            logger.warning("fleet %s: reconstructed %d stream(s) from "
                           "replica %d's journal", self.obs_label,
                           len(orphans), rep.rid)
        return orphans

    def _migrate(self, victims, dead, reason):
        """Resubmit ``victims`` (unfinished streams off ``dead``) to
        the surviving replicas: prefix-affine re-pick excluding the
        dead member, adoption via ``EngineSupervisor.resubmit`` —
        re-admission resumes from ``context()`` and replays delivered
        offsets idempotently (temperature-0 token-identical), with K/V
        prefix pages restored from the shared PageStore when present,
        degrading per-stream to a re-prefill. The per-stream
        ``fleet.failover`` fault can fail one hand-off; a stream no
        survivor accepts fails typed instead of hanging."""
        victims = [r for r in victims if not r.done.is_set()]
        if not victims:
            return 0
        moved = 0
        for r in sorted(victims, key=lambda v: v.id):
            try:
                fault_point("fleet.failover", requests=(r.id,),
                            replica=dead.rid)
            except FaultError as e:
                logger.warning("fleet %s: injected migration fault for "
                               "request %d: %r", self.obs_label, r.id, e)
                if not r.done.is_set():
                    r._finish(e)
                continue
            r._resume_cb = self._classify_resume
            placed, tried = False, {dead.rid}
            while not placed:
                try:
                    target = self._pick(r.prompt,
                                        exclude=frozenset(tried),
                                        adapter=getattr(r, "adapter",
                                                        None))
                except QueueFullError:
                    break
                tried.add(target.rid)
                try:
                    target.sup.resubmit(r)
                    placed = True
                except Exception:
                    logger.exception(
                        "fleet %s: replica %d refused migrated "
                        "request %d", self.obs_label, target.rid, r.id)
            if placed:
                moved += 1
                # cross-replica span link: the adopting replica's
                # admission continues this SAME trace (the journal or
                # the live handle carried the id across)
                reqtrace.event(getattr(r, "trace", None), "migrate",
                               request=r.id, fleet=self.obs_label,
                               from_replica=dead.rid,
                               to_replica=target.rid,
                               delivered=len(r.tokens), reason=reason)
                with self._lock:
                    self.migrated_streams += 1
                c = self._obs.get("migrations")
                if c is not None:
                    c.inc()
            else:
                r.__dict__.pop("_resume_cb", None)
                if not r.done.is_set():
                    r._finish(EngineFailedError(
                        f"no surviving replica could adopt request "
                        f"{r.id} ({reason})"))
        logger.warning("fleet %s: migrated %d/%d stream(s) off replica "
                       "%d (%s)", self.obs_label, moved, len(victims),
                       dead.rid, reason)
        return moved

    def _classify_resume(self, shared, total):
        """Planted as ``_resume_cb`` on migrated requests; the ADOPTING
        scheduler calls it at the stream's first successful admission
        with the admit's (shared, total) prefix-token split. 'restore'
        means SOME prefix K/V was reused (live prefix cache or pages
        restored from the shared store — partial or full);
        'reprefill' means the whole context was recomputed."""
        restored = shared > 0
        with self._lock:
            if restored:
                self.failover_restored += 1
            else:
                self.failover_reprefilled += 1
        c = self._obs.get("failover_restore" if restored
                          else "failover_reprefill")
        if c is not None:
            c.inc()

    # ------------------------------------------------------ health state --
    def _set_health_gauge(self, rep):
        if self._health_family is not None:
            self._health_family.labels(
                self.obs_label, str(rep.rid)).set(rep.health)

    def _eject_locked(self, rep):
        """Transition to EJECTED (idempotent; fleet lock held)."""
        if rep.health == HEALTH_EJECTED:
            return False
        rep.health = HEALTH_EJECTED
        rep.ejected_at = time.monotonic()
        rep.canary_ok = 0
        self.ejections += 1
        c = self._obs.get("ejected")
        if c is not None:
            c.inc()
        self._set_health_gauge(rep)
        return True

    def _readmit_locked(self, rep):
        """PROBATION -> OK (fleet lock held)."""
        if rep.health != HEALTH_PROBATION:
            return False
        rep.health = HEALTH_OK
        rep.submit_failures = 0
        rep.unhealthy_since = None
        self.readmissions += 1
        c = self._obs.get("readmitted")
        if c is not None:
            c.inc()
        self._set_health_gauge(rep)
        return True

    def health(self):
        """{rid: state} snapshot — 0 healthy / 1 probation / 2
        ejected (the ``bigdl_fleet_health`` gauge values)."""
        with self._lock:
            return {rep.rid: rep.health for rep in self._replicas}

    def metrics(self):
        reps = self._replicas
        return {f"replica_{rep.rid}": rep.sup.metrics() for rep in reps}

    # ---------------------------------------------------------- lifecycle --
    def close(self, drain=True, timeout=None):
        obs.default_registry().unregister_probe(self._health_probe)
        with self._lock:
            self._closed = True
            reps = self._replicas
            self._replicas = ()
        self._stop.set()
        if self._watcher is not None:
            self._watcher.join(timeout=5.0)
        for rep in reps:
            try:
                rep.sup.close(drain=drain, timeout=timeout)
            except Exception:
                logger.exception("closing replica %d failed", rep.rid)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
