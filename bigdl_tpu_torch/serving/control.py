"""Serving control plane: priorities, SLO admission, fairness, autoscaling
(the port of ``bigdl_tpu/serving/control.py``; host-side policy only, the
reference's classes and constants).

The scheduler's bounded FIFO treats every request identically: under
overload all clients degrade together and the only defence is
:class:`~bigdl_tpu_torch.serving.scheduler.QueueFullError`. This module
adds the policy layer that makes degradation *selective*:

- **Priority classes** (``interactive`` / ``standard`` / ``best_effort``)
  with weighted-fair dequeue (:class:`FairQueue`): a stride scheduler
  over per-``(priority, client)`` subqueues, so a greedy best-effort
  client can slow — but never starve — an interactive one.
- **SLO-aware admission** (:class:`ControlPolicy`): predicted TTFT from
  the engine's live ``bigdl_serving_ttft_seconds`` histogram (an EMA of
  the mean TTFT of recently retired requests), scaled by queue depth and
  slot occupancy. A request whose deadline (or its tier's TTFT SLO) the
  prediction would blow is shed if best-effort, down-tiered if standard,
  or admitted by shedding queued lower-tier work if interactive.
  Already-expired queued requests fail at dequeue time, before any
  prefill is spent on them.
- **Per-client rate limits** (:class:`TokenBucket`), rejected typed with
  :class:`RateLimitedError`.
- **Autoscaling** (:class:`AutoScaler`): a control loop over a fleet
  (``replica_count()``, ``load()``, ``scale_to(n)``) with hysteresis and
  cooldown: ``serving.router.EngineFleet``, or any object with those
  three methods, as the reference's own tests drive it.

Thread model: :class:`FairQueue` and :class:`TokenBucket` are NOT
internally locked — the scheduler mutates its queue only under its
condition lock, and the policy's buckets are touched only inside
``Scheduler.submit`` under that same lock. The autoscaler owns its own
thread and talks to the fleet through its public API only.

Admission changes *which* requests run and *when*, never *what* they
decode to: admitted requests decode token-identically to the FIFO path.
"""

from __future__ import annotations

import collections
import heapq
import inspect
import itertools
import logging
import threading
import time

from bigdl_tpu_torch import obs
from bigdl_tpu_torch.obs.anomaly import StepTimeAnomalyDetector
from bigdl_tpu_torch.serving.scheduler import QueueFullError
from bigdl_tpu_torch.utils.flags import get_flag

logger = logging.getLogger("bigdl_tpu_torch.serving.control")

#: Priority classes, highest first. Weights drive the stride scheduler:
#: an ``interactive`` subqueue advances 16 requests for every 1 a
#: ``best_effort`` subqueue does when both are backlogged.
PRIORITIES = ("interactive", "standard", "best_effort")
PRIORITY_WEIGHTS = {"interactive": 16.0, "standard": 4.0,
                    "best_effort": 1.0}
_PRIORITY_RANK = {p: i for i, p in enumerate(PRIORITIES)}


class AdmissionRejectedError(QueueFullError):
    """Admission control shed this request (SLO protection or queue
    pressure). Subclasses :class:`QueueFullError` so existing
    backpressure handling (``generate()`` retries, supervisor paths)
    keeps applying."""


class RateLimitedError(AdmissionRejectedError):
    """The client's token bucket is empty — it exceeded its configured
    request rate; retry after backoff."""


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/s refill, ``burst`` cap.

    Not internally locked — the owner (``ControlPolicy`` via
    ``Scheduler.submit``) serializes access under the scheduler's
    condition lock. ``clock`` is injectable for deterministic tests.
    """

    def __init__(self, rate, burst, clock=time.monotonic):
        if rate <= 0 or burst <= 0:
            raise ValueError(f"rate/burst must be > 0, "
                             f"got rate={rate} burst={burst}")
        self.rate = float(rate)
        self.burst = float(burst)
        self._clock = clock
        self._tokens = self.burst
        self._last = clock()

    def allow(self, n=1.0):
        """Take ``n`` tokens if available; returns False (taking
        nothing) when the bucket is short."""
        now = self._clock()
        self._tokens = min(self.burst,
                           self._tokens + (now - self._last) * self.rate)
        self._last = now
        if self._tokens < n:
            return False
        self._tokens -= n
        return True


class FairQueue:
    """Weighted start-time-fair queue, drop-in for the scheduler's deque.

    Requests are bucketed by ``(priority, client_id)``; ``popleft``
    serves the subqueue with the smallest virtual *pass*, advancing it
    by ``1/weight`` per pop — classic stride scheduling, so relative
    service rates follow :data:`PRIORITY_WEIGHTS` while every
    backlogged subqueue keeps making progress (no starvation).

    ``appendleft`` / ``extendleft`` bypass fairness entirely: they are
    the scheduler's *requeue* paths (page-exhaustion preemption,
    partial paged admission) and those requests must resume ahead of
    everything, exactly as with the plain deque.

    Supports the full surface the scheduler uses on its deque:
    ``append``, ``appendleft``, ``extendleft``, ``popleft``,
    ``remove``, ``clear``, ``len()``, iteration. Not internally
    locked — mutated only under the scheduler's condition lock.
    """

    def __init__(self, weights=None):
        self._weights = dict(PRIORITY_WEIGHTS)
        if weights:
            self._weights.update(weights)
        self._front = collections.deque()   # requeued: always served first
        self._sub = {}                      # key -> deque of requests
        self._pass = {}                     # key -> virtual pass
        self._heap = []                     # (pass, seq, key) lazy entries
        self._seq = itertools.count()
        self._vtime = 0.0
        self._len = 0

    @staticmethod
    def _key(r):
        return (getattr(r, "priority", "standard"),
                getattr(r, "client_id", None))

    def append(self, r):
        key = self._key(r)
        sub = self._sub.get(key)
        if sub is None:
            sub = self._sub[key] = collections.deque()
        if not sub:
            # re-activating subqueue: clamp its pass to the global
            # virtual time so an idle client cannot bank credit
            p = max(self._pass.get(key, 0.0), self._vtime)
            self._pass[key] = p
            heapq.heappush(self._heap, (p, next(self._seq), key))
        sub.append(r)
        self._len += 1

    def appendleft(self, r):
        self._front.appendleft(r)
        self._len += 1

    def extendleft(self, rs):
        for r in rs:
            self.appendleft(r)

    def popleft(self):
        if self._front:
            self._len -= 1
            return self._front.popleft()
        while self._heap:
            p, _, key = heapq.heappop(self._heap)
            sub = self._sub.get(key)
            if not sub or p != self._pass[key]:
                continue               # stale entry (emptied via remove)
            r = sub.popleft()
            self._len -= 1
            self._vtime = p
            if sub:
                np_ = p + 1.0 / self._weights.get(key[0], 1.0)
                self._pass[key] = np_
                heapq.heappush(self._heap, (np_, next(self._seq), key))
            return r
        raise IndexError("pop from an empty FairQueue")

    def remove(self, r):
        try:
            self._front.remove(r)
        except ValueError:
            pass
        else:
            self._len -= 1
            return
        sub = self._sub.get(self._key(r))
        if sub is not None:
            try:
                sub.remove(r)
            except ValueError:
                pass
            else:
                self._len -= 1
                return
        raise ValueError("request not in queue")

    def clear(self):
        self._front.clear()
        self._sub.clear()
        self._pass.clear()
        self._heap = []
        self._len = 0

    def pop_priority(self, priority):
        """Pop the next request of exactly ``priority`` (front requeues
        first, then the fairest subqueue of that class), or None. The
        scheduler's slot-reservation path: when only reserved slots
        remain, only interactive work may take them."""
        for r in self._front:
            if getattr(r, "priority", "standard") == priority:
                self._front.remove(r)
                self._len -= 1
                return r
        best = None
        for key, sub in self._sub.items():
            if key[0] == priority and sub:
                if best is None or self._pass[key] < self._pass[best]:
                    best = key
        if best is None:
            return None
        r = self._sub[best].popleft()
        self._len -= 1
        # charge the subqueue as popleft would (new pass invalidates the
        # old heap entry; re-push only while it still has work)
        np_ = self._pass[best] + 1.0 / self._weights.get(best[0], 1.0)
        self._pass[best] = np_
        if self._sub[best]:
            heapq.heappush(self._heap, (np_, next(self._seq), best))
        return r

    def shed_lower(self, than_priority):
        """Remove and return the NEWEST queued request of the lowest
        priority class strictly below ``than_priority`` (never touching
        the requeued front), or None when there is nothing to shed."""
        rank = _PRIORITY_RANK.get(than_priority, 1)
        for p in reversed(PRIORITIES):
            if _PRIORITY_RANK[p] <= rank:
                return None
            best = None
            for key, sub in self._sub.items():
                if key[0] == p and sub:
                    tail = sub[-1]
                    if best is None or tail.id > best[0].id:
                        best = (tail, sub)
            if best is not None:
                best[1].pop()
                self._len -= 1
                return best[0]
        return None

    def __len__(self):
        return self._len

    def __bool__(self):
        return self._len > 0

    def __iter__(self):
        yield from self._front
        for sub in self._sub.values():
            yield from sub


class ControlPolicy:
    """Admission policy the scheduler consults inside ``submit``.

    ``slo_ttft_s`` maps priority class to the TTFT budget applied when
    a request carries no explicit deadline (None disables the check for
    that class — best-effort by default has no SLO of its own, it is
    the shock absorber for everyone else's).

    Predicted TTFT = observed TTFT (p90 of the engine's live histogram,
    falling back to its running mean, then ``base_ttft_s``) scaled by
    ``1 + queue_depth / max_slots`` — each max_slots-worth of queued
    work is roughly one more prefill wave in front of the newcomer —
    and further by ``1 / (1 - occupancy)`` pressure when slots are
    nearly full. Crude, but monotone in the right signals and cheap
    enough for the submit path.

    Not internally locked: consulted only under the scheduler's
    condition lock (``Scheduler.submit``).
    """

    def __init__(self, slo_ttft_s=None, base_ttft_s=0.05,
                 rate_limit_rps=None, rate_limit_burst=None,
                 weights=None, reserved_slots=1, clock=time.monotonic):
        self.slo_ttft_s = {"interactive": 1.0, "standard": 5.0,
                           "best_effort": None}
        if slo_ttft_s:
            self.slo_ttft_s.update(slo_ttft_s)
        self.base_ttft_s = float(base_ttft_s)
        # slots only interactive admissions may take when free slots run
        # low (clamped to max_slots - 1 by the scheduler, so lower-tier
        # traffic can never be starved outright on a tiny engine)
        self.reserved_slots = int(reserved_slots)
        self.rate_limit_rps = rate_limit_rps
        self.rate_limit_burst = (rate_limit_burst
                                 if rate_limit_burst is not None
                                 else (rate_limit_rps or 0) * 2 or None)
        self.weights = weights
        self._clock = clock
        self._buckets = {}
        self._ttft_seen = {}   # engine label -> (hist sum, hist count)
        self._ttft_est = {}    # engine label -> recent-TTFT EMA

    def make_queue(self):
        return FairQueue(self.weights)

    # ------------------------------------------------------ rate limits --
    def check_rate(self, client_id):
        """True when ``client_id`` is within its rate budget (or no
        limit is configured). Unidentified clients share one bucket."""
        if self.rate_limit_rps is None:
            return True
        b = self._buckets.get(client_id)
        if b is None:
            b = self._buckets[client_id] = TokenBucket(
                self.rate_limit_rps, self.rate_limit_burst,
                clock=self._clock)
        return b.allow()

    # ------------------------------------------------------- prediction --
    def predict_ttft(self, scheduler):
        """Predicted queue-to-first-token seconds for a request
        submitted to ``scheduler`` right now."""
        # base estimate: an EMA over the mean TTFT of *recently*
        # finished requests — the cumulative histogram's quantiles never
        # forget cold-start compiles, which would overestimate forever
        key = scheduler.obs_label
        hist = scheduler._obs.get("ttft")
        if hist is not None and hist.count:
            _, s, c = hist.snapshot()
            ps, pc = self._ttft_seen.get(key, (0.0, 0))
            if c > pc:
                recent = (s - ps) / (c - pc)
                prev = self._ttft_est.get(key)
                self._ttft_est[key] = (recent if prev is None
                                       else 0.5 * prev + 0.5 * recent)
                self._ttft_seen[key] = (s, c)
            elif key in self._ttft_est:
                # no completions since the last prediction: decay toward
                # the optimistic floor so a pessimistic estimate (e.g. a
                # cold-start compile) cannot shed one tier forever — the
                # probe admissions it eventually allows refresh the EMA
                # with real data
                self._ttft_est[key] = max(self.base_ttft_s,
                                          0.98 * self._ttft_est[key])
        base = self._ttft_est.get(key)
        if base is None:
            base = scheduler.ttft_avg()
        if base is None or base <= 0:
            base = self.base_ttft_s
        slots = scheduler.slots
        depth = len(scheduler._waiting)
        predicted = base * (1.0 + depth / max(1, slots.max_slots))
        occ = slots.occupancy() / max(1, slots.max_slots)
        if occ >= 1.0:
            predicted *= 4.0
        elif occ > 0.5:
            predicted /= (1.0 - occ) * 2.0
        return predicted

    def budget_s(self, request, now=None):
        """The TTFT budget this request must meet: its own deadline's
        remaining headroom when it has one, else its tier's SLO."""
        if request.deadline is not None:
            if now is None:
                now = time.perf_counter()
            return max(0.0, request.deadline - now)
        return self.slo_ttft_s.get(
            getattr(request, "priority", "standard"))


class AutoScaler:
    """Control loop growing/shrinking an engine fleet from obs signals.

    ``fleet`` needs three methods: ``replica_count()``, ``load()``
    (dict with at least ``queue_depth``, ``occupancy`` in [0, 1], and
    optionally ``page_occupancy``, ``ttft_p90``), and ``scale_to(n)``.
    ``serving.router.EngineFleet`` provides all three, and takes the
    ``prefer_unhealthy`` this loop forwards on scale-down.

    Scale-up votes: mean queue depth per replica above
    ``up_queue_depth``, occupancy above ``up_occupancy``, page
    occupancy above ``up_occupancy``, or the rolling-median anomaly
    detector firing on observed TTFT. ``votes_to_scale`` consecutive
    polls with a vote trigger one ``scale_to(n+1)`` (hysteresis);
    ``cooldown_s`` then gates the next action. Scale-down requires
    ``idle_polls_to_retire`` consecutive polls with an empty queue and
    occupancy below ``down_occupancy``.

    Runs ``step()`` on its own daemon thread every ``poll_interval_s``
    (via ``Event.wait`` — never sleeping under a lock); tests may call
    ``step()`` directly with ``start()`` never invoked.
    """

    def __init__(self, fleet, min_replicas=1, max_replicas=4,
                 poll_interval_s=1.0, up_queue_depth=4.0,
                 up_occupancy=0.85, down_occupancy=0.25,
                 votes_to_scale=2, idle_polls_to_retire=5,
                 cooldown_s=5.0, prefer_unhealthy=True,
                 obs_label="0", clock=time.monotonic):
        if min_replicas < 1 or max_replicas < min_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{min_replicas}..{max_replicas}")
        self.fleet = fleet
        # scale-down should retire broken capacity first (a circuit-open
        # replica over a healthy one) — forwarded to fleets whose
        # scale_to accepts the keyword, so plain stubs keep working
        self.prefer_unhealthy = bool(prefer_unhealthy)
        try:
            params = inspect.signature(fleet.scale_to).parameters
            self._scale_takes_pref = "prefer_unhealthy" in params
        except (TypeError, ValueError):
            self._scale_takes_pref = False
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.poll_interval_s = float(poll_interval_s)
        self.up_queue_depth = float(up_queue_depth)
        self.up_occupancy = float(up_occupancy)
        self.down_occupancy = float(down_occupancy)
        self.votes_to_scale = int(votes_to_scale)
        self.idle_polls_to_retire = int(idle_polls_to_retire)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._up_votes = 0
        self._idle_polls = 0
        self._last_action = None
        self._ttft_seen = (0.0, 0)
        self.scale_ups = 0
        self.scale_downs = 0
        # guards the decision state and action counters: step() is
        # callable from the poll thread AND directly by callers/tests
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None
        self._anomaly = StepTimeAnomalyDetector(loop="serving-ttft")
        reg = obs.default_registry()
        lbl = ("fleet",)
        e = str(obs_label)
        self._obs = {
            "replicas": reg.gauge(
                "bigdl_fleet_replicas",
                "engine replicas currently serving", lbl).labels(e),
            "scale_ups": reg.counter(
                "bigdl_fleet_scale_ups_total",
                "autoscaler replica additions", lbl).labels(e),
            "scale_downs": reg.counter(
                "bigdl_fleet_scale_downs_total",
                "autoscaler replica retirements", lbl).labels(e),
        }
        self._obs["replicas"].set(fleet.replica_count())

    # ---------------------------------------------------------- lifecycle --
    def start(self):
        if self._thread is not None:
            return self
        self._thread = threading.Thread(target=self._run,
                                        name="bigdl-tpu-autoscaler",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout=5.0):
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
        self._thread = None

    def _run(self):
        while not self._stop.wait(self.poll_interval_s):
            try:
                self.step()
            except Exception:
                logger.exception("autoscaler step failed; continuing")

    # -------------------------------------------------------- one decision --
    def step(self):
        """One observe-decide-act cycle. Returns +1/-1/0 for the action
        taken (deterministic given the fleet's signals — tests drive it
        directly). Decision state lives under ``_lock`` (step is
        callable from both the poll thread and callers); the blocking
        ``scale_to`` — replica builds take seconds — runs outside it."""
        with self._lock:
            act, n, why = self._decide_locked()
        if act == 0:
            return 0
        if act < 0 and self._scale_takes_pref:
            self.fleet.scale_to(
                n + act, prefer_unhealthy=self.prefer_unhealthy)
        else:
            self.fleet.scale_to(n + act)
        with self._lock:
            if act > 0:
                self.scale_ups += 1
                self._obs["scale_ups"].inc()
            else:
                self.scale_downs += 1
                self._obs["scale_downs"].inc()
            self._obs["replicas"].set(n + act)
            # cooldown runs from action COMPLETION: a slow replica build
            # must not eat the settling time the cooldown is for
            self._last_action = self._clock()
        if act > 0:
            logger.info("autoscaler: scaled up to %d replicas (%s)",
                        n + act, why)
        else:
            logger.info("autoscaler: retired one replica (now %d)",
                        n + act)
        return act

    def _decide_locked(self):
        """Observe + vote (``_lock`` held). Returns ``(action,
        replica_count, reason)`` with action in {+1, -1, 0}."""
        n = self.fleet.replica_count()
        load = self.fleet.load()
        self._obs["replicas"].set(n)
        depth = float(load.get("queue_depth", 0.0))
        occ = float(load.get("occupancy", 0.0))
        page_occ = float(load.get("page_occupancy", 0.0))
        # anomaly detection wants a WINDOWED signal: the cumulative
        # histogram's p90 never forgets cold-start compiles, so feed the
        # detector the mean TTFT of just the requests finished since the
        # last poll
        anomalous = False
        s, c = (float(load.get("ttft_sum", 0.0)),
                int(load.get("ttft_count", 0)))
        ps, pc = self._ttft_seen
        if c > pc and s >= ps:
            anomalous = self._anomaly.observe((s - ps) / (c - pc))
        self._ttft_seen = (s, c)
        vote_up = (depth / max(1, n) >= self.up_queue_depth
                   or occ >= self.up_occupancy
                   or page_occ >= self.up_occupancy
                   or anomalous)
        idle = depth == 0 and occ <= self.down_occupancy
        now = self._clock()
        cooling = (self._last_action is not None
                   and now - self._last_action < self.cooldown_s)
        if vote_up:
            self._idle_polls = 0
            self._up_votes += 1
            if (self._up_votes >= self.votes_to_scale
                    and n < self.max_replicas and not cooling):
                self._up_votes = 0
                return 1, n, (f"depth={depth:.1f} occ={occ:.2f} "
                              f"page={page_occ:.2f} anomaly={anomalous}")
            return 0, n, ""
        self._up_votes = 0
        if idle:
            self._idle_polls += 1
            if (self._idle_polls >= self.idle_polls_to_retire
                    and n > self.min_replicas and not cooling):
                self._idle_polls = 0
                return -1, n, "idle"
        else:
            self._idle_polls = 0
        return 0, n, ""


def policy_from_flags():
    """Build a :class:`ControlPolicy` from ``BIGDL_TPU_*`` environment
    flags, or None when ``BIGDL_TPU_ADMISSION_SLO`` is unset/falsy (the
    default: plain FIFO). ``BIGDL_TPU_TTFT_SLO_INTERACTIVE_S`` (1.0) and
    ``BIGDL_TPU_TTFT_SLO_STANDARD_S`` (5.0) set the tiers' TTFT SLOs,
    ``BIGDL_TPU_RATE_LIMIT_RPS`` / ``BIGDL_TPU_RATE_LIMIT_BURST`` the
    per-client rate limit (none by default)."""
    if str(get_flag("BIGDL_TPU_ADMISSION_SLO", "0")).lower() not in (
            "1", "true", "yes", "on"):
        return None
    slo = {
        "interactive": get_flag("BIGDL_TPU_TTFT_SLO_INTERACTIVE_S",
                                1.0, float),
        "standard": get_flag("BIGDL_TPU_TTFT_SLO_STANDARD_S", 5.0, float),
        "best_effort": None,
    }
    rps = get_flag("BIGDL_TPU_RATE_LIMIT_RPS", None, float)
    burst = get_flag("BIGDL_TPU_RATE_LIMIT_BURST", None, float)
    return ControlPolicy(slo_ttft_s=slo, rate_limit_rps=rps,
                         rate_limit_burst=burst)
