"""Iteration-level scheduler: FIFO admission, batched (dense) or chunked
(paged) prefill, token-step loop, streaming (the port of
``bigdl_tpu/serving/scheduler.py``).

Requests are admitted into free slots and retired on EOS/max-tokens at
block granularity (continuous batching): a new arrival waits only for a
free slot, never for someone else's whole generation.

Thread model: ONE scheduler thread owns the slot manager — every device
dispatch happens there (the thread sets the CUDA device it serves on).
``submit`` only appends to the bounded waiting deque under the condition
lock. A full queue rejects with :class:`QueueFullError`.

Failure model (the reference's): the loop never dies holding requests.
A prompt the slot table cannot hold fails alone; page exhaustion is
handled (a new request waits; a decoding one is preempted and resumes
later from its context). Any other exception in an admission, a prefill
chunk, a page reservation or a decode step triggers in-place recovery:
the slot table is rebuilt (``SlotManager.reset``) and every affected
request re-placed from its full context (prompt + delivered tokens, so
nothing is re-streamed), bisecting the group to quarantine a request that
fails every probe alone (only it fails; the rest continue). A batched
admission that fails before it touched the card falls back to one request
at a time. Past ``max_recoveries`` (``BIGDL_TPU_SERVING_MAX_RECOVERIES``,
8) recoveries, or when the slot table cannot even be rebuilt (a sticky
CUDA error: the card refuses every later call), the loop gives up
cleanly: every handle resolves with ``EngineFailedError`` caused by the
error, or goes to an attached ``failover`` (the ``EngineSupervisor``), and
new submissions fail. The loop beats a heartbeat each iteration so a
supervisor can tell wedged from idle. Requests carry optional deadlines
and support ``cancel()``, both enforced at block boundaries.

Fault sites (``resilience/faults.py``): ``serving.admit`` before each
admission, ``serving.step`` before each decode block; the slot managers
add ``serving.prefill`` and ``serving.page_alloc``.

With a ``KVSnapshot`` (``serving/snapshot.py``) admissions, delivered
chunks and retirements are journalled, and a page snapshot pass runs
after a decode block at most every ``snapshot_interval_s``.

Control plane (``serving/control.py``): with a ``ControlPolicy`` the
waiting queue is a weighted-fair ``FairQueue`` over (priority, client)
subqueues and ``submit`` consults the policy under the condition lock
(per-client rate limits, SLO-aware admission that sheds best-effort work,
down-tiers standard work, or sheds queued lower-tier work to admit an
interactive request); the admission pop holds ``reserved_slots`` free
slots back for interactive work. ``policy=None`` keeps the plain FIFO
deque.

Telemetry (``obs``): every counter also lives on the obs default
registry under the reference's families, labelled ``engine=<obs_label>``
(admissions, rejections, retirements, tokens, step seconds, queue depth,
occupancy, TTFT with the trace as its exemplar, recovery counters, and on
the paged path the page, prefix-cache, host-tier, snapshot and
speculation families); host spans ``serve/prefill``,
``serve/prefill_chunk``, ``serve/step`` and ``serve/snapshot`` on the
scheduler thread; request-trace events (submit, admit, tokens, retire,
preempt, quarantine, failed, adapter_cold, ...) and a flight-recorder note
per decode iteration.

Multi-tenant LoRA (the slot manager's ``adapter_pool``): a request naming
an adapter is resolved at admission (:meth:`Scheduler._resolve_batch`):
its pool row acquired and its prefix chain seeded from the adapter's
digest. At most one cold adapter load rides a scheduler iteration; a
request whose adapter is cold past that budget, or finds every pool row
referenced while other streams are in flight, goes back to the queue's
front; an unknown adapter, a failed load, or an exhausted pool with
nothing in flight fails that request alone with ``AdapterLoadError``.
The row is released whenever the request leaves the engine (retired,
failed, cancelled, expired, preempted, given up); a recovery re-places it
under the row it holds, and a supervisor's resubmission re-resolves it
under the new engine's pool.
"""

from __future__ import annotations

import collections
import itertools
import logging
import queue
import threading
import time

import numpy as np
import torch

from bigdl_tpu_torch import obs
from bigdl_tpu_torch.obs import reqtrace
from bigdl_tpu_torch.resilience.faults import fault_point
from bigdl_tpu_torch.serving.adapters import (AdapterColdError,
                                              AdapterLoadError,
                                              AdapterPoolExhausted)
from bigdl_tpu_torch.serving.paging import PagePoolExhausted, chain_seed
from bigdl_tpu_torch.utils.flags import get_flag

logger = logging.getLogger("bigdl_tpu_torch.serving")

# TTFT needs finer low-end resolution than the latency defaults (the
# reference's buckets)
TTFT_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)


class QueueFullError(RuntimeError):
    """The waiting queue is at ``max_queue`` — backpressure; retry later."""


class EngineClosedError(RuntimeError):
    """The engine is shut down (or the request was cancelled by it)."""


class EngineFailedError(EngineClosedError):
    """The loop exhausted its recovery budget (or could not rebuild its
    slot table) and halted; new submissions fail until a supervisor
    restarts the engine."""


class RequestCancelledError(RuntimeError):
    """The request was cancelled; its slot has been freed."""


class DeadlineExceededError(RuntimeError):
    """The request's ``deadline_s`` elapsed before completion; its slot
    has been freed."""


class _Halt(BaseException):
    """Internal: unwind the scheduler loop (abandoned or gave up). Never
    escapes ``Scheduler._loop``."""


_DONE = object()


PRIORITIES = ("interactive", "standard", "best_effort")


class Request:
    """One generation request and its token stream: iterate it for
    streaming tokens, or call :meth:`result` to block for the full
    sequence. ``deadline_s`` is a wall-clock TTL from submission.

    ``priority`` (one of ``PRIORITIES``) and ``client_id`` only matter to
    a scheduler built with a ``serving.control.ControlPolicy``: they drive
    weighted-fair dequeue, per-client rate limits, and which requests
    admission control sheds first. ``trace`` is the request-trace ID
    (``obs.reqtrace``), minted by ``ServingEngine.submit``. ``adapter`` names
    the LoRA adapter the request decodes under (a registered name or a
    digest, raw or hex; None: the base model), resolved at admission into
    ``adapter_digest``; on an engine without an adapter pool such a
    request fails at admission with ``AdapterLoadError``, as the
    reference's does with ``BIGDL_TPU_LORA`` off."""

    _ids = itertools.count()

    def __init__(self, prompt, max_new_tokens, temperature=0.0,
                 eos_token=None, deadline_s=None, priority="standard",
                 client_id=None, adapter=None):
        if priority not in PRIORITIES:
            raise ValueError(f"unknown priority {priority!r}; expected "
                             f"interactive/standard/best_effort")
        self.priority = priority
        self.client_id = client_id
        self.adapter = adapter
        self.adapter_digest = None     # resolved at admission
        self._adapter_slot = 0         # pool row while in flight (0: base)
        self._adapter_seed = None      # the prefix chain seed of the adapter
        self.trace = None
        self.id = next(Request._ids)
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError("empty prompt")
        if int(max_new_tokens) < 1:
            raise ValueError(f"max_new_tokens must be >= 1, "
                             f"got {max_new_tokens}")
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature or 0.0)
        self.eos_token = None if eos_token is None else int(eos_token)
        self.tokens = []
        # bounded by construction: at most max_new_tokens + end sentinel
        self._stream = queue.Queue(self.max_new_tokens + 1)
        self.error = None
        self.done = threading.Event()
        self.submitted_at = time.perf_counter()
        if deadline_s is not None and float(deadline_s) <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        self.deadline = (None if deadline_s is None
                         else self.submitted_at + float(deadline_s))
        self.first_token_at = None
        self.finished_at = None
        # True when the slot ran out of positions before max_new_tokens
        self.truncated = False
        self._cancelled = False
        self._scheduler = None

    # ------------------------------------------------ scheduler-side hooks
    def _deliver(self, chunk):
        """Append one block's tokens (a list of ints) in one stream put."""
        if self.first_token_at is None:
            self.first_token_at = time.perf_counter()
        self.tokens.extend(chunk)
        self._stream.put(chunk)

    def _finish(self, error=None):
        self.error = error
        self.finished_at = time.perf_counter()
        self._stream.put(_DONE)
        self.done.set()

    def context(self):
        """Prompt + every token already delivered — what a preempted
        request re-prefills, so no token is ever streamed twice."""
        if not self.tokens:
            return self.prompt
        return np.concatenate([self.prompt,
                               np.asarray(self.tokens, np.int32)])

    def remaining(self):
        return self.max_new_tokens - len(self.tokens)

    # -------------------------------------------------------- caller side
    def cancel(self):
        """Cancel from any thread: a waiting request fails at once with
        :class:`RequestCancelledError`; an in-flight one is retired at the
        next block boundary. Returns False when already finished."""
        if self.done.is_set():
            return False
        self._cancelled = True
        sch = self._scheduler
        if sch is not None:
            sch.cancel(self)
        return True

    def __iter__(self):
        """Stream tokens as they are generated (blocking); a failed or
        cancelled request raises its error after the last token."""
        while True:
            item = self._stream.get()
            if item is _DONE:
                break
            yield from item
        if self.error is not None:
            raise self.error

    def result(self, timeout=None):
        """Block until finished; returns prompt + generated tokens as one
        int32 array, or re-raises the request's error."""
        if not self.done.wait(timeout):
            raise TimeoutError(f"request {self.id} still in flight after "
                               f"{timeout}s")
        if self.error is not None:
            raise self.error
        return np.concatenate([self.prompt,
                               np.asarray(self.tokens, np.int32)])


class Scheduler:
    """FIFO admission + iteration-level decode loop over a dense
    :class:`~bigdl_tpu_torch.serving.slots.SlotManager` or a
    :class:`~bigdl_tpu_torch.serving.paging.PagedSlotManager` (see module
    docstring). Owns the background thread; built and shut down by
    ``ServingEngine``. ``failover(victims, error)``, when given, receives
    every unfinished request instead of their being failed when the loop
    gives up (the ``EngineSupervisor`` hook). ``max_recoveries`` bounds
    in-place recoveries over the scheduler's life (default
    ``BIGDL_TPU_SERVING_MAX_RECOVERIES``, 8). ``snapshot`` is the engine's
    ``KVSnapshot`` or None. ``policy`` is a
    ``serving.control.ControlPolicy`` or None (FIFO). ``obs_label`` labels
    this engine's series on the obs registry (default: a per-process
    counter)."""

    _obs_ids = itertools.count()

    def __init__(self, slots, max_queue=64, admit_wait_s=0.0, failover=None,
                 max_recoveries=None, snapshot=None, policy=None,
                 obs_label=None):
        self.slots = slots
        self._snap = snapshot
        self.max_queue = int(max_queue)
        self.admit_wait_s = float(admit_wait_s)
        self._policy = policy
        self._waiting = (collections.deque() if policy is None
                         else policy.make_queue())
        self._cond = threading.Condition()
        self._accepting = True
        self._drain = True
        self._abandoned = False
        self._failover = failover
        self.failed = None
        if max_recoveries is None:
            max_recoveries = get_flag("BIGDL_TPU_SERVING_MAX_RECOVERIES", 8,
                                      int)
        self.max_recoveries = int(max_recoveries)
        self._inflight = {}        # slot -> Request (loop thread only)
        # requests the loop holds outside _waiting and _inflight (a popped
        # admission batch, a recovery set): abandon() and _give_up() must
        # see them
        self._limbo = []
        self.admitted = 0
        self.rejected = 0
        self.retired = 0
        self.generated_tokens = 0
        self.step_seconds = 0.0
        self.cancelled = 0
        self.deadline_expired = 0
        self.failures = 0
        self.recoveries = 0
        self.quarantined = 0
        self.preempted = 0
        self.shed = 0
        self.rate_limited = 0
        self.downtiered = 0
        # re-placed streams after a recovery: restored (whole context from
        # the prefix cache, tier or store) or re-prefilled, and the context
        # tokens recomputed (counted with a snapshot attached)
        self.restored_streams = 0
        self.reprefilled_streams = 0
        self.replayed_tokens = 0
        # after a preemption, hold new admissions until a retirement frees
        # pages (the evicted stream must not re-admit into the full pool)
        self._stall_admissions = False
        self.heartbeat = time.monotonic()
        self._busy = False
        self._ttft_sum = 0.0
        if obs_label is None:
            obs_label = str(next(Scheduler._obs_ids))
        self.obs_label = str(obs_label)
        # the slot manager's cumulative counts last published (the
        # registry takes their deltas)
        self._paged_published = {}
        self._spec_published = {}
        self._obs = self._instruments()
        self._thread = threading.Thread(target=self._loop,
                                        name="bigdl-tpu-torch-serving",
                                        daemon=True)
        self._update_paged_gauges()
        self._thread.start()

    def _instruments(self):
        """This engine's series on the obs default registry: the
        reference's families, label names, help strings and buckets,
        labelled ``engine=<obs_label>`` so many engines share a
        registry. Paged, host-tier, snapshot, speculative and policy
        families exist only where the engine has that part."""
        slots = self.slots
        reg = obs.default_registry()
        lbl = ("engine",)
        e = self.obs_label
        o = {
            "admitted": reg.counter(
                "bigdl_serving_admitted_total",
                "requests admitted into slots", lbl).labels(e),
            "rejected": reg.counter(
                "bigdl_serving_rejected_total",
                "requests rejected (queue full or engine closed)",
                lbl).labels(e),
            "retired": reg.counter(
                "bigdl_serving_retired_total",
                "requests served to completion", lbl).labels(e),
            "generated_tokens": reg.counter(
                "bigdl_serving_generated_tokens_total",
                "tokens delivered to callers", lbl).labels(e),
            "step_seconds": reg.counter(
                "bigdl_serving_step_seconds_total",
                "wall seconds inside decode-step dispatches", lbl).labels(e),
            "queue_depth": reg.gauge(
                "bigdl_serving_queue_depth",
                "requests waiting for a slot", lbl).labels(e),
            "slot_occupancy": reg.gauge(
                "bigdl_serving_slot_occupancy",
                "slots currently decoding", lbl).labels(e),
            "tokens_per_sec": reg.gauge(
                "bigdl_serving_decode_tokens_per_sec",
                "cumulative decode throughput", lbl).labels(e),
            "ttft": reg.histogram(
                "bigdl_serving_ttft_seconds",
                "submit-to-first-token latency", lbl,
                buckets=TTFT_BUCKETS).labels(e),
            "failures": reg.counter(
                "bigdl_serving_failures_total",
                "decode-loop step/admit exceptions caught", lbl).labels(e),
            "recoveries": reg.counter(
                "bigdl_serving_recoveries_total",
                "in-place slot-table recoveries", lbl).labels(e),
            "quarantined": reg.counter(
                "bigdl_serving_quarantined_total",
                "poisoned requests failed alone by recovery", lbl).labels(e),
            "cancelled": reg.counter(
                "bigdl_serving_cancelled_total",
                "requests cancelled by their caller", lbl).labels(e),
            "deadline_exceeded": reg.counter(
                "bigdl_serving_deadline_exceeded_total",
                "requests failed by their deadline TTL", lbl).labels(e),
            "heartbeat": reg.gauge(
                "bigdl_serving_heartbeat_timestamp",
                "unix time of the loop's last liveness beat", lbl).labels(e),
            "tp_degree": reg.gauge(
                "bigdl_serving_tp_degree",
                "tensor-parallel degree of the engine's serving mesh "
                "(1 = unsharded single-device)", lbl).labels(e),
            "mesh_devices": reg.gauge(
                "bigdl_mesh_devices",
                "devices in the engine's serving mesh", lbl).labels(e),
        }
        # static for the engine's lifetime
        o["tp_degree"].set(slots.tp)
        o["mesh_devices"].set(slots.tp)
        if self._policy is not None:
            shed = reg.counter(
                "bigdl_serving_shed_total",
                "requests shed by admission control",
                ("engine", "priority"))
            o.update({
                "shed_interactive": shed.labels(e, "interactive"),
                "shed_standard": shed.labels(e, "standard"),
                "shed_best_effort": shed.labels(e, "best_effort"),
                "rate_limited": reg.counter(
                    "bigdl_serving_rate_limited_total",
                    "requests rejected by per-client rate limits",
                    lbl).labels(e),
                "downtiered": reg.counter(
                    "bigdl_serving_downtiered_total",
                    "standard requests demoted to best_effort by SLO "
                    "admission", lbl).labels(e),
            })
        if slots.paged:
            o.update({
                "preempted": reg.counter(
                    "bigdl_serving_preempted_total",
                    "in-flight requests preempted by page exhaustion",
                    lbl).labels(e),
                "pages_in_use": reg.gauge(
                    "bigdl_serving_pages_in_use",
                    "K/V pages referenced by live streams", lbl).labels(e),
                "pages_total": reg.gauge(
                    "bigdl_serving_pages_total",
                    "K/V page pool size", lbl).labels(e),
                "page_occupancy": reg.gauge(
                    "bigdl_serving_page_occupancy",
                    "fraction of the K/V page pool in use", lbl).labels(e),
                "fragmentation_tokens": reg.gauge(
                    "bigdl_serving_kv_fragmentation_tokens",
                    "allocated-but-unused K/V token capacity",
                    lbl).labels(e),
                "prefix_hits": reg.counter(
                    "bigdl_serving_prefix_cache_hits_total",
                    "admissions that reused a cached prefix",
                    lbl).labels(e),
                "prefix_misses": reg.counter(
                    "bigdl_serving_prefix_cache_misses_total",
                    "admissions with no cached prefix", lbl).labels(e),
                "prefix_hit_tokens": reg.counter(
                    "bigdl_serving_prefix_hit_tokens_total",
                    "prompt tokens served from the prefix cache",
                    lbl).labels(e),
                "prefix_miss_tokens": reg.counter(
                    "bigdl_serving_prefix_miss_tokens_total",
                    "prompt tokens prefilled from scratch", lbl).labels(e),
                "kv_bytes_per_token": reg.gauge(
                    "bigdl_serving_kv_bytes_per_token",
                    "K/V bytes per cached token across all layers "
                    "(int8 pools include their scale planes)",
                    lbl).labels(e),
                "kv_bytes_per_token_per_chip": reg.gauge(
                    "bigdl_serving_kv_bytes_per_token_per_chip",
                    "K/V bytes ONE chip pays per cached token: 1/tp of "
                    "the global figure under a tensor-parallel mesh "
                    "(equal to it at tp=1)", lbl).labels(e),
            })
            if slots.host_tier is not None:
                o.update({
                    "host_tier_demoted": reg.counter(
                        "bigdl_kv_host_tier_demoted_pages_total",
                        "evicted pool pages swapped out to the host "
                        "tier", lbl).labels(e),
                    "host_tier_promoted": reg.counter(
                        "bigdl_kv_host_tier_promoted_pages_total",
                        "pages swapped back into the pool from the host "
                        "tier", lbl).labels(e),
                    "host_tier_hits": reg.counter(
                        "bigdl_kv_host_tier_hits_total",
                        "promotion probes served by the host tier",
                        lbl).labels(e),
                    "host_tier_misses": reg.counter(
                        "bigdl_kv_host_tier_misses_total",
                        "promotion probes that fell through to the "
                        "PageStore / re-prefill rungs", lbl).labels(e),
                    "host_tier_evicted": reg.counter(
                        "bigdl_kv_host_tier_evicted_pages_total",
                        "resident pages dropped by the tier's own LRU "
                        "byte-budget eviction", lbl).labels(e),
                    "host_tier_corrupt": reg.counter(
                        "bigdl_kv_host_tier_corrupt_dropped_total",
                        "resident pages dropped on checksum mismatch "
                        "(degraded down the ladder)", lbl).labels(e),
                    "host_tier_resident_bytes": reg.gauge(
                        "bigdl_kv_host_tier_resident_bytes",
                        "pinned-host bytes the tier holds", lbl).labels(e),
                    "host_tier_resident_pages": reg.gauge(
                        "bigdl_kv_host_tier_resident_pages",
                        "pages resident in the host tier", lbl).labels(e),
                    "host_tier_stall": reg.counter(
                        "bigdl_kv_host_tier_swap_stall_seconds_total",
                        "owner-thread seconds spent on swap staging and "
                        "promotion fetches (the overlap residual)",
                        lbl).labels(e),
                })
        if self._snap is not None:
            streams = reg.counter(
                "bigdl_recovery_streams_total",
                "recovered streams by mode: restore resumed from "
                "snapshotted K/V pages, reprefill recomputed",
                ("engine", "mode"))
            o.update({
                "recovery_replayed": reg.counter(
                    "bigdl_recovery_replayed_tokens_total",
                    "context tokens recomputed (not restored) while "
                    "re-placing recovered streams", lbl).labels(e),
                "recovery_restore": streams.labels(e, "restore"),
                "recovery_reprefill": streams.labels(e, "reprefill"),
            })
        if slots.spec_tokens > 1:
            o.update({
                "spec_proposed": reg.counter(
                    "bigdl_serving_spec_proposed_total",
                    "draft tokens proposed for verification",
                    lbl).labels(e),
                "spec_accepted": reg.counter(
                    "bigdl_serving_spec_accepted_total",
                    "draft tokens the target model accepted",
                    lbl).labels(e),
                "spec_rollbacks": reg.counter(
                    "bigdl_serving_spec_rollbacks_total",
                    "draft tokens rejected and rolled back",
                    lbl).labels(e),
                "spec_accept_rate": reg.gauge(
                    "bigdl_serving_spec_accept_rate",
                    "cumulative fraction of proposed draft tokens "
                    "accepted", lbl).labels(e),
            })
        return o

    # -------------------------------------------------------- caller side
    def held_admission(self):
        """The scheduler's lock, as a context: no admission pass runs
        while it is held, so the requests submitted inside reach one pass
        together (``ServingEngine.submit_many``). Re-entrant."""
        return self._cond

    def submit(self, request, force=False):
        """Enqueue a request (any thread). Raises ``EngineFailedError``
        after the loop halted, ``EngineClosedError`` after shutdown and
        ``QueueFullError`` at capacity. ``force`` bypasses the queue bound
        and the admission policy (resubmission: recovered requests must
        not be bounced by their own backlog).

        With a ``ControlPolicy`` attached, submission also enforces
        per-client rate limits (``RateLimitedError``) and SLO-aware
        admission: a request whose predicted TTFT blows its budget is shed
        if best-effort (``AdmissionRejectedError``), demoted to
        best-effort if standard, or, if interactive, admitted while a
        queued lower-tier request is shed instead."""
        with self._cond:
            if self.failed is not None:
                self._reject_locked()
                raise EngineFailedError(
                    f"serving engine failed: {self.failed!r}")
            if not self._accepting:
                self._reject_locked()
                raise EngineClosedError("engine is shut down")
            if self._policy is not None and not force:
                self._control_locked(request)
            if not force and len(self._waiting) >= self.max_queue:
                self._reject_locked()
                raise QueueFullError(
                    f"waiting queue full ({self.max_queue} requests); "
                    f"retry later")
            request._scheduler = self
            self._waiting.append(request)
            self._obs["queue_depth"].set(len(self._waiting))
            self._cond.notify()
        return request

    def _reject_locked(self):
        self.rejected += 1
        self._obs["rejected"].inc()

    def _control_locked(self, request):
        """Admission policy for one incoming request (cond lock held).
        Raises the typed rejection, mutates ``request.priority`` on
        down-tier, or sheds a queued victim to admit an interactive
        request (the reference's rules)."""
        from bigdl_tpu_torch.serving.control import (AdmissionRejectedError,
                                                     RateLimitedError)
        pol = self._policy
        if not pol.check_rate(request.client_id):
            self._reject_locked()
            self.rate_limited += 1
            self._obs["rate_limited"].inc()
            raise RateLimitedError(
                f"client {request.client_id!r} exceeded its rate limit "
                f"({pol.rate_limit_rps}/s); retry later")
        now = time.perf_counter()
        budget = pol.budget_s(request, now=now)
        slo_blown = (budget is not None
                     and pol.predict_ttft(self) > budget)
        queue_full = len(self._waiting) >= self.max_queue
        if not slo_blown and not queue_full:
            return
        if request.priority == "best_effort" and slo_blown:
            self._count_shed_locked(request)
            raise AdmissionRejectedError(
                f"request {request.id} (best_effort) shed: predicted "
                f"TTFT exceeds its {budget:.3f}s budget")
        if request.priority == "standard" and slo_blown:
            request.priority = "best_effort"
            self.downtiered += 1
            self._obs["downtiered"].inc()
        # a higher-tier request under pressure: make room by shedding the
        # newest queued strictly-lower-tier request (best_effort first)
        while slo_blown or len(self._waiting) >= self.max_queue:
            victim = self._waiting.shed_lower(request.priority)
            if victim is None:
                break
            self._count_shed_locked(victim)
            self._obs["queue_depth"].set(len(self._waiting))
            victim._finish(AdmissionRejectedError(
                f"request {victim.id} ({victim.priority}) shed from the "
                f"queue to admit higher-priority work"))
            slo_blown = False   # the freed headroom is the remedy

    def _pop_batch_locked(self, n, free):
        """Policy-aware admission pop (cond lock held): weighted-fair
        order through the ``FairQueue``, except that the last
        ``min(reserved_slots, max_slots - 1)`` free slots are held back for
        ``interactive`` requests, so a best-effort flood fills the engine
        only up to the reservation line. Both tables admit through it."""
        reserved = min(self._policy.reserved_slots,
                       self.slots.max_slots - 1)
        batch = []
        while len(batch) < n and self._waiting:
            if reserved and free - len(batch) <= reserved:
                r = self._waiting.pop_priority("interactive")
                if r is None:
                    break
                batch.append(r)
            else:
                batch.append(self._waiting.popleft())
        return batch

    def _count_shed_locked(self, r):
        self._reject_locked()
        self.shed += 1
        counter = self._obs.get("shed_" + r.priority)
        if counter is not None:
            counter.inc()

    def cancel(self, request):
        """Cancel a request (any thread): a waiting one fails at once, an
        in-flight one at the next block boundary."""
        request._cancelled = True
        with self._cond:
            if request.done.is_set():
                return False
            try:
                self._waiting.remove(request)
            except ValueError:
                self._cond.notify()    # in flight: swept at the boundary
                return True
            self._obs["queue_depth"].set(len(self._waiting))
        self._swept(request,
                    RequestCancelledError(f"request {request.id} cancelled"))
        return True

    def queue_depth(self):
        with self._cond:
            return len(self._waiting)

    def ttft_avg(self):
        return (self._ttft_sum / self.retired) if self.retired else None

    def ttft_histogram(self):
        """The engine's TTFT histogram child on the obs registry: the
        accessor routers and autoscalers read instead of ``_obs``."""
        return self._obs.get("ttft")

    def is_alive(self):
        return self._thread.is_alive()

    def heartbeat_age(self):
        """Seconds since the loop last proved liveness: its heartbeat, or
        the end of a restore (the slot manager's ``restore_ended``),
        whichever came later. The restore's end counts because the loop
        beats only after the rest of its iteration, and a poll between the
        two would read a restore that the grace covered as a wedge."""
        last = max(self.heartbeat, getattr(self.slots, "restore_ended", 0.0))
        return time.monotonic() - last

    @property
    def restore_active(self):
        """True while the slot manager loads pages from the host tier or
        the page store (the supervisor extends its wedge grace)."""
        return bool(getattr(self.slots, "restore_active", False))

    def shutdown(self, drain=True, timeout=None):
        """Stop accepting. ``drain=True`` serves everything queued and in
        flight first; ``drain=False`` fails it with ``EngineClosedError``.
        Joins the thread; returns False if it is still alive after
        ``timeout`` (wedged in a dispatch: treat the engine as dead)."""
        with self._cond:
            self._accepting = False
            self._drain = drain
            self._cond.notify()
        self._thread.join(timeout)
        if self._thread.is_alive():
            logger.warning("scheduler thread still alive %s s after "
                           "shutdown (wedged in a dispatch?)", timeout)
            return False
        return True

    def abandon(self):
        """Supervisor hand-off: stop this (possibly wedged) loop from ever
        touching its requests again and return the unfinished ones. The
        loop observes the flag at its next safe point and exits without
        finishing anything. A second call returns nothing: the first
        caller owns those requests (a fleet evacuation migrates them, and
        the supervisor's later rebuild must not resubmit them again)."""
        with self._cond:
            if self._abandoned:
                return []
            self._abandoned = True
            self._accepting = False
            pool = (list(self._waiting) + list(self._limbo)
                    + list(self._inflight.values()))
            self._waiting.clear()
            self._obs["queue_depth"].set(0)
            self._cond.notify()
        seen, victims = set(), []
        for r in pool:
            if r.id not in seen and not r.done.is_set():
                seen.add(r.id)
                # the row means nothing outside this engine's pool, which
                # the wedged loop may still use: the resubmission
                # re-resolves from r.adapter
                r._adapter_slot = 0
                r.adapter_digest = None
                victims.append(r)
        return victims

    # ----------------------------------------------------- scheduler loop
    def _loop(self):
        try:
            dev = self.slots.device
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
            # build or load the kernels before the first heartbeat, so
            # the build never reads as a wedge to a supervisor
            self.slots.warm_kernels()
            self._beat(busy=False)
            self._serve()
        except _Halt:
            pass
        except BaseException as e:   # nobody may hang on a dead loop
            logger.exception("serving loop died")
            try:
                self._give_up(e)
            except _Halt:
                pass

    def _beat(self, busy=None):
        if busy is not None:
            self._busy = busy
        self.heartbeat = time.monotonic()
        self._obs["heartbeat"].set(time.time())

    def _serve(self):
        slots = self.slots
        while True:
            if self._abandoned:
                raise _Halt
            self._beat(busy=False)
            batch = []
            with self._cond:
                while (self._accepting and not self._waiting
                       and not self._inflight):
                    self._cond.wait()
                if self._abandoned:
                    raise _Halt
                if not self._accepting and not self._drain:
                    err = EngineClosedError("engine shut down")
                    while self._waiting:
                        w = self._waiting.popleft()
                        w._finish(err)
                        self._journal_retire(w)
                    for s, r in list(self._inflight.items()):
                        slots.retire(s)
                        r._finish(err)
                        self._journal_retire(r)
                    self._inflight.clear()
                    self._obs["queue_depth"].set(0)
                    self._obs["slot_occupancy"].set(0)
                    return
                self._sweep_waiting_locked()
                if not self._waiting and not self._inflight:
                    if not self._accepting:
                        return
                    continue
                # with nothing decoding yet, hold admission up to
                # admit_wait_s so a burst lands in one admission batch
                if (self.admit_wait_s > 0 and self._accepting
                        and not self._inflight
                        and 0 < len(self._waiting) < slots.window):
                    deadline = time.perf_counter() + self.admit_wait_s
                    remaining = self.admit_wait_s
                    while (self._accepting and remaining > 0
                           and len(self._waiting) < slots.window):
                        self._cond.wait(remaining)
                        remaining = deadline - time.perf_counter()
                    self._sweep_waiting_locked()
                n = min(len(self._waiting), slots.window,
                        slots.free_slots())
                if self._stall_admissions:
                    if self._inflight:
                        n = 0      # wait for a retirement to free pages
                    else:
                        self._stall_admissions = False
                if n and self._policy is not None:
                    batch = self._pop_batch_locked(n, slots.free_slots())
                else:
                    batch = [self._waiting.popleft() for _ in range(n)]
                self._limbo = list(batch)
                self._obs["queue_depth"].set(len(self._waiting))
            self._beat(busy=True)
            self._sweep_inflight()
            if slots.paged and slots.host_tier is not None:
                self._prefetch_host_tier()
            if batch:
                if slots.paged:
                    self._admit_paged(batch)
                else:
                    self._admit(batch)
                self._limbo = []
                self._beat()
            if slots.pending_prefills():
                # ONE chunk dispatch per loop iteration, interleaved with
                # the decode block below
                try:
                    with obs.span("serve/prefill_chunk",
                                  pending=slots.pending_prefills()):
                        slots.prefill_tick()
                except _Halt:
                    raise
                except BaseException as e:
                    self._failed_dispatch()
                    self._recover(list(self._inflight.values()), e)
                    continue
                self._beat()
                self._update_paged_gauges()
            if not self._inflight:
                continue
            if not any(slots.active[s] for s in self._inflight):
                continue           # everything in flight is prefilling
            try:
                slots.reserve_block()
            except _Halt:
                raise
            except PagePoolExhausted as e:
                self._preempt(e)
                continue
            except BaseException as e:
                self._failed_dispatch()
                self._recover(list(self._inflight.values()), e)
                continue
            pre_lengths = slots.lengths.copy()
            t0 = time.perf_counter()
            try:
                fault_point("serving.step",
                            requests=tuple(r.id
                                           for r in self._inflight.values()))
                with obs.span("serve/step", live=len(self._inflight)):
                    toks = slots.step()    # (block_span, max_slots)
            except _Halt:
                raise
            except BaseException as e:
                self._failed_dispatch()
                self._recover(list(self._inflight.values()), e)
                continue
            if self._abandoned:
                raise _Halt
            self._beat()
            dt = time.perf_counter() - t0
            self.step_seconds += dt
            self._obs["step_seconds"].inc(dt)
            self._deliver_block(toks, pre_lengths)
            self._maybe_snapshot()
            self._update_spec_gauges()
            self._update_paged_gauges()
            if reqtrace.enabled():
                with self._cond:
                    queued = len(self._waiting)
                it = {"live": len(self._inflight), "queued": queued,
                      "step_s": dt, "generated": self.generated_tokens}
                if slots.spec_proposed:
                    it["spec_proposed"] = slots.spec_proposed
                    it["spec_accepted"] = slots.spec_accepted
                reqtrace.default_flight().note_iteration(self.obs_label,
                                                         **it)

    def _failed_dispatch(self):
        self.failures += 1
        self._obs["failures"].inc()

    # ------------------------------------------------------- publishing
    def _update_paged_gauges(self):
        """Publish the page-pool / prefix-cache / host-tier snapshot on
        this engine's registry series (paged engines only): levels as
        gauges, the manager's cumulative counts as counter deltas."""
        if "pages_in_use" not in self._obs:
            return
        st = self.slots.pool_stats()
        o = self._obs
        o["pages_in_use"].set(st["pages_in_use"])
        o["pages_total"].set(st["num_pages"])
        o["page_occupancy"].set(st["page_occupancy"])
        o["fragmentation_tokens"].set(st["fragmentation_tokens"])
        o["kv_bytes_per_token"].set(st["kv_bytes_per_token"])
        o["kv_bytes_per_token_per_chip"].set(
            st["kv_bytes_per_token_per_chip"])
        pairs = [(k, k) for k in ("prefix_hits", "prefix_misses",
                                  "prefix_hit_tokens", "prefix_miss_tokens")]
        if "host_tier_resident_bytes" in o:
            o["host_tier_resident_bytes"].set(
                st["host_tier_resident_bytes"])
            o["host_tier_resident_pages"].set(
                st["host_tier_resident_pages"])
            pairs += [("host_tier_demoted", "host_tier_demoted_pages"),
                      ("host_tier_promoted", "host_tier_promoted_pages"),
                      ("host_tier_hits", "host_tier_hits"),
                      ("host_tier_misses", "host_tier_misses"),
                      ("host_tier_evicted", "host_tier_evicted_pages"),
                      ("host_tier_corrupt", "host_tier_corrupt_dropped"),
                      ("host_tier_stall", "host_tier_swap_stall_s")]
        for obs_k, st_k in pairs:
            delta = st[st_k] - self._paged_published.get(st_k, 0)
            if delta > 0:
                o[obs_k].inc(delta)
            self._paged_published[st_k] = st[st_k]

    def _update_spec_gauges(self):
        """Publish the speculative counters' deltas and the cumulative
        accept rate (engines with ``spec_tokens`` > 1 only)."""
        if "spec_proposed" not in self._obs:
            return
        sl = self.slots
        for k, v in (("spec_proposed", sl.spec_proposed),
                     ("spec_accepted", sl.spec_accepted),
                     ("spec_rollbacks", sl.spec_rollbacks)):
            delta = v - self._spec_published.get(k, 0)
            if delta > 0:
                self._obs[k].inc(delta)
            self._spec_published[k] = v
        if sl.spec_proposed:
            self._obs["spec_accept_rate"].set(
                sl.spec_accepted / sl.spec_proposed)

    # ----------------------------------------------------------- journal
    def _journal_admit(self, r):
        if self._snap is None:
            return
        try:
            self._snap.admit(r)
        except Exception:
            logger.exception("journal admit failed (ignored)")

    def _journal_delivered(self, r, n):
        """Record the ``n`` just-delivered tokens (the tail of
        ``r.tokens``) at their stream offset: replay is idempotent on
        offsets, so a torn tail can never double-deliver."""
        if self._snap is None or not n:
            return
        try:
            off = len(r.tokens) - n
            self._snap.delivered(r, off, r.tokens[off:])
        except Exception:
            logger.exception("journal delivery failed (ignored)")

    def _journal_retire(self, r):
        """Tombstone a finished request (compaction keeps the journal
        bounded; the store drops the request's page pins) and release its
        adapter row: the one hook every request passes through when it
        leaves the engine."""
        self._release_adapter(r)
        if self._snap is None:
            return
        try:
            self._snap.retire(r.id)
        except Exception:
            logger.exception("journal retire failed (ignored)")

    def _maybe_snapshot(self, force=False):
        """Rate-limited page snapshot pass (loop thread, between
        dispatches): the registered prefix-cache pages plus the full-block
        pages of live streams go to the store's writer thread. Never fails
        the loop."""
        snap = self._snap
        if snap is None or not self.slots.paged:
            return
        if not (force or snap.due()):
            return
        try:
            streams = [(r.id, r.context(), s, r._adapter_seed)
                       for s, r in list(self._inflight.items())
                       if self.slots.active[s]]
            with obs.span("serve/snapshot", streams=len(streams)):
                snap.snapshot(self.slots, streams, force=force)
        except Exception:
            logger.exception("kv snapshot pass failed (serving continues)")

    def _count_resume(self, r):
        """Classify one re-placed stream after a recovery: restored when
        its whole context came from the prefix cache, the tier or the
        store (a logits-only replay), re-prefilled otherwise; the
        recomputed tokens add to ``replayed_tokens``."""
        shared = int(getattr(self.slots, "last_admit_shared", 0))
        total = int(getattr(self.slots, "last_admit_total", 0))
        replayed = max(0, total - shared)
        self.replayed_tokens += replayed
        if replayed:
            self._obs["recovery_replayed"].inc(replayed)
        if total and shared >= total:
            self.restored_streams += 1
            self._obs["recovery_restore"].inc()
        else:
            self.reprefilled_streams += 1
            self._obs["recovery_reprefill"].inc()

    def _trace_admitted(self, r):
        """One ``admit`` timeline event, with the prefix-restore split the
        paged manager reports (``shared`` tokens came from the cache, the
        tier or the store); ``delivered`` > 0 marks a re-placement."""
        reqtrace.event(
            r.trace, "admit", request=r.id, engine=self.obs_label,
            delivered=len(r.tokens),
            shared=int(getattr(self.slots, "last_admit_shared", 0)),
            total=int(getattr(self.slots, "last_admit_total", 0)))

    def _consume_resume_cb(self, r):
        """A caller migrating ``r`` may plant ``_resume_cb`` on the handle:
        the first admission here calls it once with the slot manager's
        shared and total token counts of that admission."""
        cb = r.__dict__.pop("_resume_cb", None)
        if cb is None:
            return
        try:
            cb(int(getattr(self.slots, "last_admit_shared", 0)),
               int(getattr(self.slots, "last_admit_total", 0)))
        except Exception:
            logger.exception("resume callback failed (ignored)")

    # -------------------------------------------------- adapter multiplex
    def _release_adapter(self, r):
        """Drop the request's adapter row reference (idempotent; row 0, the
        base model, holds none)."""
        row = r._adapter_slot
        if not row:
            return
        r._adapter_slot = 0
        pool = getattr(self.slots, "adapter_pool", None)
        if pool is not None:
            try:
                pool.release(row)
            except Exception:
                logger.exception("adapter release failed (ignored)")

    def _resolve_adapter(self, r, allow_load=True):
        """Resolve and acquire the request's adapter row (loop thread).
        Returns ``"ok"`` (row and chain seed set on the request),
        ``"requeue"`` (cold past this iteration's load, or every row
        referenced while streams are in flight) or ``"failed"`` (finished
        with ``AdapterLoadError``)."""
        if r.adapter is None:
            r._adapter_slot = 0
            r._adapter_seed = None
            return "ok"
        if r._adapter_slot:
            return "ok"                # re-placement: the row is still held
        pool = getattr(self.slots, "adapter_pool", None)
        if pool is None:
            self._fail_adapter(r, AdapterLoadError(
                f"request {r.id} names adapter {r.adapter!r} but the "
                f"engine has no adapter pool (BIGDL_TPU_LORA off)"))
            return "failed"
        try:
            digest = pool.resolve(r.adapter)
        except KeyError:
            self._fail_adapter(r, AdapterLoadError(
                f"request {r.id}: unknown adapter {r.adapter!r}"))
            return "failed"
        try:
            row = pool.acquire(digest, allow_load=allow_load)
        except AdapterColdError:
            reqtrace.event(r.trace, "adapter_cold", request=r.id,
                           engine=self.obs_label,
                           adapter=digest.hex() if isinstance(
                               digest, bytes) else str(digest))
            return "requeue"
        except AdapterPoolExhausted as e:
            if self._inflight:
                return "requeue"       # a retirement frees a row
            self._fail_adapter(r, AdapterLoadError(str(e)))
            return "failed"
        except AdapterLoadError as e:
            self._fail_adapter(r, e)
            return "failed"
        r.adapter_digest = digest
        r._adapter_slot = int(row)
        r._adapter_seed = chain_seed(digest)
        return "ok"

    def _fail_adapter(self, r, err):
        logger.warning("request %d fails at admission: %s", r.id, err)
        with self._cond:
            self._reject_locked()
        r._finish(err)
        self._journal_retire(r)

    def _resolve_batch(self, batch):
        """Adapter resolution of a popped admission batch, one cold load
        an iteration; requests to requeue go back to the queue's front in
        order. Returns the admissible rest."""
        if all(r.adapter is None and not r._adapter_slot for r in batch):
            return batch
        pool = getattr(self.slots, "adapter_pool", None)
        loads0 = getattr(pool, "loads", 0)
        live, requeue = [], []
        for r in batch:
            allow = getattr(pool, "loads", 0) == loads0
            state = self._resolve_adapter(r, allow_load=allow)
            if state == "ok":
                live.append(r)
            elif state == "requeue":
                requeue.append(r)
        if requeue:
            with self._cond:
                self._waiting.extendleft(reversed(requeue))
                self._obs["queue_depth"].set(len(self._waiting))
        return live

    def _admitted(self, r, s):
        with self._cond:
            self._inflight[s] = r
        self.admitted += 1
        self._obs["admitted"].inc()
        self._journal_admit(r)
        self._consume_resume_cb(r)
        self._trace_admitted(r)

    # ---------------------------------------------------------- admission
    def _admit(self, batch):
        """Dense admission: one batched prefill dispatch of the batch's
        prompts (a prompt the table cannot hold fails alone, before the
        dispatch). On failure the batch falls back to one request at a
        time, so only a poisoned request fails; a dispatch that failed
        after it reached the card poisons the table, and everything is
        re-placed by a recovery."""
        slots = self.slots
        live = []
        for r in self._resolve_batch(self._expire_batch(batch)):
            if r.context().size > slots.max_position - 1:
                with self._cond:
                    self._reject_locked()
                r._finish(ValueError(
                    f"prompt of {r.context().size} tokens exceeds the slot "
                    f"capacity of {slots.max_position - 1}"))
                self._journal_retire(r)
            else:
                live.append(r)
        if not live:
            return
        try:
            fault_point("serving.admit", requests=tuple(r.id for r in live))
            with obs.span("serve/prefill", n=len(live)):
                assigned = slots.admit([r.context() for r in live],
                                       [r.temperature for r in live],
                                       [r._adapter_slot for r in live])
        except _Halt:
            raise
        except BaseException as e:
            self._failed_dispatch()
            logger.warning("batched admission failed (%r); admitting %d "
                           "request(s) one at a time", e, len(live))
            if slots.poisoned:
                self._recover(list(self._inflight.values()) + live, e)
                return
            for r in live:
                try:
                    fault_point("serving.admit", requests=(r.id,))
                    (s,) = slots.admit([r.context()], [r.temperature],
                                       [r._adapter_slot])
                except _Halt:
                    raise
                except BaseException as e2:
                    if slots.poisoned:
                        rest = [x for x in live
                                if x is not r and not x.done.is_set()]
                        self._quarantine(r, e2)
                        self._recover(
                            list(self._inflight.values()) + rest, e2)
                        return
                    self._quarantine(r, e2)
                else:
                    self._admitted(r, s)
        else:
            for r, s in zip(live, assigned):
                self._admitted(r, s)
        self._obs["slot_occupancy"].set(slots.occupancy())

    def _admit_paged(self, batch):
        """Per-request page allocation + pending-prefill enqueue (host
        work only; ``prefill_tick`` dispatches the chunks). Exhaustion
        with other work holding the pool requeues the rest of the batch
        at the queue FRONT and stalls admission until a retirement; with
        the pool all to itself the request can never fit and fails typed.
        Any other failure that left the pools clean is retried once, as the
        dense path retries a failed batch one request at a time (the
        reference quarantines at once), so a transient fault costs a retry;
        a second failure quarantines the request, and a recovery follows
        when the failure poisoned the pools (a restore's page load)."""
        slots = self.slots
        batch = self._resolve_batch(self._expire_batch(batch))

        def admit_one(r):
            fault_point("serving.admit", requests=(r.id,))
            return slots.admit_one(r.context(), r.temperature,
                                   adapter_slot=r._adapter_slot,
                                   seed=r._adapter_seed)

        for i, r in enumerate(batch):
            try:
                try:
                    s = admit_one(r)
                except (_Halt, PagePoolExhausted, ValueError):
                    raise
                except BaseException as e:
                    if slots.poisoned:
                        raise
                    self._failed_dispatch()
                    logger.warning("admission of request %d failed (%r); "
                                   "retrying it once", r.id, e)
                    s = admit_one(r)
            except _Halt:
                raise
            except PagePoolExhausted as e:
                if self._inflight or i:
                    rest = [x for x in batch[i:] if not x.done.is_set()]
                    logger.warning("page pool exhausted admitting request "
                                   "%d; requeueing %d request(s)", r.id,
                                   len(rest))
                    with self._cond:
                        self._waiting.extendleft(reversed(rest))
                        self._obs["queue_depth"].set(len(self._waiting))
                    self._stall_admissions = True
                    break
                with self._cond:
                    self._reject_locked()
                r._finish(e)
                self._journal_retire(r)
            except ValueError as e:      # a prompt the table cannot hold
                with self._cond:
                    self._reject_locked()
                r._finish(e)
                self._journal_retire(r)
            except BaseException as e:
                self._failed_dispatch()
                if slots.poisoned:
                    rest = [x for x in batch[i:]
                            if x is not r and not x.done.is_set()]
                    self._quarantine(r, e)
                    self._recover(list(self._inflight.values()) + rest, e)
                    return
                self._quarantine(r, e)
            else:
                self._admitted(r, s)
        self._obs["slot_occupancy"].set(slots.occupancy())
        self._update_paged_gauges()

    def _prefetch_host_tier(self):
        """Swap-in lookahead: promote the next waiting prompts' demoted
        prefix pages one iteration ahead of their admission, so the
        admission's registry walk hits the pool instead of stalling on the
        tier. At most ``host_tier_prefetch`` pages an iteration, from the
        queue's first two requests."""
        slots = self.slots
        left = int(slots.host_tier_prefetch)
        if left <= 0:
            return
        with self._cond:
            heads = [(w.prompt, w.adapter)
                     for w in itertools.islice(self._waiting, 2)]
        pool = getattr(slots, "adapter_pool", None)
        for prompt, ref in heads:
            if left <= 0:
                break
            seed = None
            if ref is not None:
                # an unknown adapter fails at admission anyway
                try:
                    seed = chain_seed(pool.resolve(ref))
                except (AttributeError, KeyError):
                    continue
            try:
                left -= slots.prefetch_prefix(prompt, left, seed=seed)
            except Exception:
                logger.exception("host-tier prefetch failed (admission "
                                 "will promote or re-prefill instead)")
                return

    def _preempt(self, error):
        """Decode-time page exhaustion: preempt the NEWEST in-flight
        request: retire its slot (freeing its pages) and requeue it at the
        front with its delivered tokens intact, so older streams keep
        decoding. With a host tier its written pages are registered first,
        so eviction demotes them and its resume promotes a full prefix hit.
        A lone stream that cannot reserve its next positions can never
        finish: it fails typed instead."""
        slots = self.slots
        if len(self._inflight) <= 1:
            for s, r in list(self._inflight.items()):
                with self._cond:
                    del self._inflight[s]
                    self._reject_locked()
                slots.retire(s)
                reqtrace.event(r.trace, "failed", request=r.id,
                               engine=self.obs_label,
                               reason="page_pool_exhausted")
                r._finish(error)
                self._journal_retire(r)
            self._obs["slot_occupancy"].set(slots.occupancy())
            self._update_paged_gauges()
            return
        s = max(self._inflight, key=lambda s: self._inflight[s].id)
        with self._cond:
            r = self._inflight.pop(s)
        if slots.host_tier is not None:
            try:
                slots.preserve_stream(r.context(), s, seed=r._adapter_seed)
            except Exception:
                logger.exception("preempt page preserve failed (the stream "
                                 "will re-prefill)")
        slots.retire(s)
        # out of the engine until its re-admission: its row must not pin
        # the adapter pool's LRU meanwhile
        self._release_adapter(r)
        self.preempted += 1
        self._obs["preempted"].inc()
        reqtrace.event(r.trace, "preempt", request=r.id,
                       engine=self.obs_label, delivered=len(r.tokens))
        reqtrace.default_flight().note_event(
            self.obs_label, "preempt", request=r.id,
            delivered=len(r.tokens))
        logger.warning("page pool exhausted (%s); preempting request %d "
                       "(%d tokens delivered, will resume)", error, r.id,
                       len(r.tokens))
        with self._cond:
            self._waiting.appendleft(r)
            self._obs["queue_depth"].set(len(self._waiting))
        self._stall_admissions = True
        self._obs["slot_occupancy"].set(slots.occupancy())
        self._update_paged_gauges()

    # ----------------------------------------------------------- delivery
    def _deliver_block(self, toks, pre_lengths):
        """Fan one block's token columns out to the in-flight requests,
        retiring EOS/max-token completions. A speculative manager commits
        a variable count a slot (``last_counts``): column ``s`` is read up
        to it. ``pre_lengths`` (slot lengths before the dispatch) bounds
        each column to the positions the slot can hold: a request reaching
        ``max_position`` is force-retired (``Request.truncated``)."""
        done = []
        tokens_before = self.generated_tokens
        counts = self.slots.last_counts
        for s, r in self._inflight.items():
            if not self.slots.active[s]:
                continue           # still prefilling in chunks
            col = toks[:, s] if counts is None else toks[:counts[s], s]
            col = col[:r.remaining()]
            finished = col.size == r.remaining()
            room = max(0, int(self.slots.max_position) - int(pre_lengths[s]))
            capped = col.size >= room
            if capped:
                col = col[:room]
            if r.eos_token is not None:
                hits = np.nonzero(col == r.eos_token)[0]
                if hits.size:
                    col = col[:int(hits[0]) + 1]
                    finished = True
                    capped = False
            if capped:
                finished = True
                if col.size < r.remaining():
                    r.truncated = True
            r._deliver(col.tolist())
            self._journal_delivered(r, col.size)
            if col.size:
                # stream offsets, not counts: a re-placed stream's offsets
                # continue where its delivered tokens stopped
                reqtrace.event(r.trace, "tokens", request=r.id,
                               engine=self.obs_label,
                               off=len(r.tokens) - int(col.size),
                               n=int(col.size))
            self.generated_tokens += col.size
            if finished:
                done.append(s)
        delivered = self.generated_tokens - tokens_before
        if delivered:
            self._obs["generated_tokens"].inc(delivered)
        for s in done:
            with self._cond:
                r = self._inflight.pop(s)
            self.slots.retire(s)
            self.retired += 1
            self._stall_admissions = False   # pages/slots freed
            ttft = ((r.first_token_at - r.submitted_at)
                    if r.first_token_at is not None else 0.0)
            self._ttft_sum += ttft
            self._obs["retired"].inc()
            # exemplar: an outlier TTFT bucket keeps this trace ID, so
            # /metrics.json leads to the request's timeline
            self._obs["ttft"].observe(ttft, exemplar=r.trace)
            reqtrace.event(r.trace, "retire", request=r.id,
                           engine=self.obs_label, tokens=len(r.tokens),
                           ttft_s=ttft, truncated=r.truncated)
            r._finish()
            self._journal_retire(r)
        if self.step_seconds:
            self._obs["tokens_per_sec"].set(
                self.generated_tokens / self.step_seconds)
        if done:
            self._obs["slot_occupancy"].set(self.slots.occupancy())

    # -------------------------------------------- cancel/deadline sweeps
    def _swept(self, r, err):
        deadline = isinstance(err, DeadlineExceededError)
        reqtrace.event(r.trace, "deadline" if deadline else "cancelled",
                       request=r.id, engine=self.obs_label,
                       delivered=len(r.tokens))
        r._finish(err)
        self._journal_retire(r)
        # the cond's RLock makes the locked-sweep path re-entrant here;
        # cancel() reaches this from the caller thread
        with self._cond:
            if deadline:
                self.deadline_expired += 1
            else:
                self.cancelled += 1
        self._obs["deadline_exceeded" if deadline else "cancelled"].inc()

    def _sweep_waiting_locked(self):
        """Drop cancelled/expired waiting requests (cond lock held).
        Collect-then-remove, so it works on the deque and the
        ``FairQueue`` alike."""
        if not self._waiting:
            return
        now = time.perf_counter()
        dead = [r for r in self._waiting
                if r._cancelled or (r.deadline is not None
                                    and now >= r.deadline)]
        if not dead:
            return
        for r in dead:
            self._waiting.remove(r)
            if r._cancelled:
                self._swept(r, RequestCancelledError(
                    f"request {r.id} cancelled"))
            else:
                self._swept(r, DeadlineExceededError(
                    f"request {r.id} exceeded its deadline after "
                    f"{now - r.submitted_at:.3f}s in queue"))
        self._obs["queue_depth"].set(len(self._waiting))

    def _expire_batch(self, batch):
        """Re-check a popped admission batch at the prefill boundary: a
        request cancelled or expired meanwhile fails here, before any
        prefill is spent on it. Returns the still-live batch."""
        now = time.perf_counter()
        live = []
        for r in batch:
            if r.done.is_set():
                continue
            if r._cancelled:
                self._swept(r, RequestCancelledError(
                    f"request {r.id} cancelled"))
            elif r.deadline is not None and now >= r.deadline:
                self._swept(r, DeadlineExceededError(
                    f"request {r.id} exceeded its deadline after "
                    f"{now - r.submitted_at:.3f}s before prefill"))
            else:
                live.append(r)
        return live

    def _sweep_inflight(self):
        """Retire cancelled/expired in-flight requests, freeing their
        slots (loop thread, between dispatches)."""
        now = time.perf_counter()
        for s, r in list(self._inflight.items()):
            if r._cancelled:
                err = RequestCancelledError(f"request {r.id} cancelled")
            elif r.deadline is not None and now >= r.deadline:
                err = DeadlineExceededError(
                    f"request {r.id} exceeded its deadline after "
                    f"{now - r.submitted_at:.3f}s "
                    f"({len(r.tokens)}/{r.max_new_tokens} tokens)")
            else:
                continue
            with self._cond:
                del self._inflight[s]
            self.slots.retire(s)
            self._swept(r, err)
            self._stall_admissions = False   # pages/slots freed
            self._obs["slot_occupancy"].set(self.slots.occupancy())

    # ----------------------------------------------------------- recovery
    def _quarantine(self, r, err):
        logger.warning("quarantining poisoned request %d: %r", r.id, err)
        self.quarantined += 1
        self._obs["quarantined"].inc()
        reqtrace.event(r.trace, "quarantine", request=r.id,
                       engine=self.obs_label, error=repr(err)[:120])
        r._finish(err)
        self._journal_retire(r)

    def _reset_slots(self):
        """Rebuild the slot table; when even that fails the card refuses
        every call (a sticky CUDA error), no request is to blame, and the
        loop gives up."""
        try:
            self.slots.reset()
        except BaseException as e:
            logger.error("slot-table reset failed (%r): the device is "
                         "unusable; giving up", e)
            self._give_up(e)

    def _place(self, reqs, probe):
        """Rebuild the slot table and re-prefill ``reqs`` from their full
        context (idempotent: delivered tokens are part of the prompt now,
        never re-streamed). With ``probe`` also run one step block and
        deliver it. Returns the still-live requests."""
        slots = self.slots
        self._reset_slots()
        with self._cond:
            self._inflight.clear()
        self._stall_admissions = False
        reqs = [r for r in reqs if not r.done.is_set()]
        # a recovered request still holds its adapter row; a resubmitted
        # one arrives without and resolves here
        reqs = self._resolve_batch(reqs)
        # restore accounting needs one admission a request (the manager's
        # last_admit_* are per admission); otherwise window-sized batches
        count = self._snap is not None and slots.paged
        i = 0
        while i < len(reqs):
            take = 1 if count else min(slots.window, slots.free_slots())
            chunk = reqs[i:i + take]
            fault_point("serving.admit", requests=tuple(r.id for r in chunk))
            kw = {"adapter_slots": [r._adapter_slot for r in chunk]}
            if slots.paged:
                kw["seeds"] = [r._adapter_seed for r in chunk]
            assigned = slots.admit([r.context() for r in chunk],
                                   [r.temperature for r in chunk], **kw)
            with self._cond:
                for r, s in zip(chunk, assigned):
                    self._inflight[s] = r
            for r in chunk:
                if count:
                    self._count_resume(r)
                self._consume_resume_cb(r)
                self._trace_admitted(r)
            i += len(chunk)
        if probe and self._inflight:
            # the block's positions need their pages (a context that ends
            # on a page boundary writes its next token into a new page)
            slots.reserve_block()
            fault_point("serving.step",
                        requests=tuple(r.id for r in self._inflight.values()))
            pre_lengths = slots.lengths.copy()
            toks = slots.step()
            if self._abandoned:
                raise _Halt
            self._beat()
            self._deliver_block(toks, pre_lengths)
            self._update_spec_gauges()
        self._obs["slot_occupancy"].set(slots.occupancy())
        self._update_paged_gauges()
        return list(self._inflight.values())

    def _recover(self, affected, error):
        """In-place recovery from a failed admission, chunk, reservation
        or step: reset the slot table, then group-bisect the affected
        requests: a group whose probe block fails is split until the
        poisoned request is alone and quarantined; everyone else resumes
        from their exact context. Past the recovery budget, or past ``2 n
        + 8`` probes, the loop gives up cleanly."""
        self.recoveries += 1
        self._obs["recoveries"].inc()
        if self.recoveries > self.max_recoveries:
            logger.error("recovery budget exhausted (%d > %d); halting",
                         self.recoveries, self.max_recoveries)
            self._give_up(error)
        affected = [r for r in affected if not r.done.is_set()]
        logger.warning("recovering the serving loop after %r: %d "
                       "request(s) to re-place (recovery %d/%d)", error,
                       len(affected), self.recoveries, self.max_recoveries)
        self._limbo = list(affected)
        with self._cond:
            self._inflight.clear()
        healthy = []
        groups = [affected] if affected else []
        probes = 0
        clean = not groups
        while groups:
            probes += 1
            if probes > 2 * len(affected) + 8:
                self._give_up(error)
            g = groups.pop(0)
            try:
                healthy = self._place(healthy + g, probe=True)
                clean = True
            except _Halt:
                raise
            except BaseException as e:
                clean = False
                g = [r for r in g if not r.done.is_set()]
                healthy = [r for r in healthy if not r.done.is_set()]
                if len(g) <= 1:
                    if g:
                        self._quarantine(g[0], e)
                else:
                    mid = len(g) // 2
                    groups[:0] = [g[:mid], g[mid:]]
        if not clean:
            try:
                self._place(healthy, probe=False)
            except _Halt:
                raise
            except BaseException as e:
                self._give_up(e)
        self._limbo = []
        self._beat()

    def _give_up(self, error):
        """Terminal failure: resolve EVERY outstanding handle (to the
        failover, or with an ``EngineFailedError`` caused by ``error``),
        mark the scheduler failed and halt the loop."""
        with self._cond:
            self._accepting = False
            self.failed = error
            pool = (list(self._waiting) + list(self._limbo)
                    + list(self._inflight.values()))
            self._waiting.clear()
            self._inflight.clear()
            # decided with the drain: an abandon() after the lock drops
            # collects nothing, and the supervisor merges what failover
            # banks, deduped by request id
            handoff = self._failover is not None and not self._abandoned
            self._obs["queue_depth"].set(0)
        self._limbo = []
        seen, victims = set(), []
        for r in pool:
            if r.id not in seen and not r.done.is_set():
                seen.add(r.id)
                # leaving this engine either way: a failover resubmits it
                # under another engine's pool
                self._release_adapter(r)
                r.adapter_digest = None
                victims.append(r)
        try:
            self.slots.reset()
        except Exception:
            logger.exception("slot-table reset failed during give-up")
        self._obs["slot_occupancy"].set(0)
        if handoff:
            logger.warning("handing %d request(s) to failover after %r",
                           len(victims), error)
            for r in victims:
                reqtrace.event(r.trace, "failover_handoff", request=r.id,
                               engine=self.obs_label,
                               delivered=len(r.tokens))
            try:
                self._failover(victims, error)
                victims = []
            except Exception:
                logger.exception("failover handler failed; failing "
                                 "requests instead")
        err = EngineFailedError(f"serving engine failed: {error!r}")
        err.__cause__ = error
        for r in victims:
            reqtrace.event(r.trace, "failed", request=r.id,
                           engine=self.obs_label, error=repr(error)[:120])
            r._finish(err)
            # failover victims stay live in the journal (they resubmit
            # elsewhere); only terminally failed ones retire
            self._journal_retire(r)
        raise _Halt
