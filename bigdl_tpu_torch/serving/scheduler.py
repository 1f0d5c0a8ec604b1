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

from bigdl_tpu_torch.resilience.faults import fault_point
from bigdl_tpu_torch.serving.adapters import AdapterLoadError
from bigdl_tpu_torch.serving.paging import PagePoolExhausted
from bigdl_tpu_torch.utils.flags import get_flag

logger = logging.getLogger("bigdl_tpu_torch.serving")


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

    ``priority`` (one of ``PRIORITIES``) and ``client_id`` are carried and
    have no other effect, as in the reference without a control policy
    (the policy is ROADMAP queue A.8). ``adapter`` names a LoRA adapter:
    the port has no adapter pool (A.8), so such a request fails at
    admission with ``AdapterLoadError``, as the reference's does with
    ``BIGDL_TPU_LORA`` off."""

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
    ``KVSnapshot`` or None."""

    def __init__(self, slots, max_queue=64, admit_wait_s=0.0, failover=None,
                 max_recoveries=None, snapshot=None):
        self.slots = slots
        self._snap = snapshot
        self.max_queue = int(max_queue)
        self.admit_wait_s = float(admit_wait_s)
        self._waiting = collections.deque()
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
        self._thread = threading.Thread(target=self._loop,
                                        name="bigdl-tpu-torch-serving",
                                        daemon=True)
        self._thread.start()

    # -------------------------------------------------------- caller side
    def submit(self, request, force=False):
        """Enqueue a request (any thread). Raises ``EngineFailedError``
        after the loop halted, ``EngineClosedError`` after shutdown and
        ``QueueFullError`` at capacity. ``force`` bypasses the queue bound
        (resubmission: recovered requests must not be bounced by their
        own backlog)."""
        with self._cond:
            if self.failed is not None:
                self.rejected += 1
                raise EngineFailedError(
                    f"serving engine failed: {self.failed!r}")
            if not self._accepting:
                self.rejected += 1
                raise EngineClosedError("engine is shut down")
            if not force and len(self._waiting) >= self.max_queue:
                self.rejected += 1
                raise QueueFullError(
                    f"waiting queue full ({self.max_queue} requests); "
                    f"retry later")
            request._scheduler = self
            self._waiting.append(request)
            self._cond.notify()
        return request

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
        self._swept(request,
                    RequestCancelledError(f"request {request.id} cancelled"))
        return True

    def queue_depth(self):
        with self._cond:
            return len(self._waiting)

    def ttft_avg(self):
        return (self._ttft_sum / self.retired) if self.retired else None

    def is_alive(self):
        return self._thread.is_alive()

    def heartbeat_age(self):
        """Seconds since the loop last proved liveness."""
        return time.monotonic() - self.heartbeat

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
        finishing anything."""
        with self._cond:
            self._abandoned = True
            self._accepting = False
            pool = (list(self._waiting) + list(self._limbo)
                    + list(self._inflight.values()))
            self._waiting.clear()
            self._cond.notify()
        seen, victims = set(), []
        for r in pool:
            if r.id not in seen and not r.done.is_set():
                seen.add(r.id)
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
                batch = [self._waiting.popleft() for _ in range(n)]
                self._limbo = list(batch)
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
                    slots.prefill_tick()
                except _Halt:
                    raise
                except BaseException as e:
                    self.failures += 1
                    self._recover(list(self._inflight.values()), e)
                    continue
                self._beat()
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
                self.failures += 1
                self._recover(list(self._inflight.values()), e)
                continue
            pre_lengths = slots.lengths.copy()
            t0 = time.perf_counter()
            try:
                fault_point("serving.step",
                            requests=tuple(r.id
                                           for r in self._inflight.values()))
                toks = slots.step()        # (block_span, max_slots)
            except _Halt:
                raise
            except BaseException as e:
                self.failures += 1
                self._recover(list(self._inflight.values()), e)
                continue
            if self._abandoned:
                raise _Halt
            self._beat()
            self.step_seconds += time.perf_counter() - t0
            self._deliver_block(toks, pre_lengths)
            self._maybe_snapshot()

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
        bounded; the store drops the request's page pins)."""
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
            streams = [(r.id, r.context(), s)
                       for s, r in list(self._inflight.items())
                       if self.slots.active[s]]
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
        self.replayed_tokens += max(0, total - shared)
        if total and shared >= total:
            self.restored_streams += 1
        else:
            self.reprefilled_streams += 1

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

    def _admitted(self, r, s):
        with self._cond:
            self._inflight[s] = r
        self.admitted += 1
        self._journal_admit(r)
        self._consume_resume_cb(r)

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
        for r in self._expire_batch(batch):
            if r.context().size > slots.max_position - 1:
                with self._cond:
                    self.rejected += 1
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
            assigned = slots.admit([r.context() for r in live],
                                   [r.temperature for r in live])
        except _Halt:
            raise
        except BaseException as e:
            self.failures += 1
            logger.warning("batched admission failed (%r); admitting %d "
                           "request(s) one at a time", e, len(live))
            if slots.poisoned:
                self._recover(list(self._inflight.values()) + live, e)
                return
            for r in live:
                try:
                    fault_point("serving.admit", requests=(r.id,))
                    (s,) = slots.admit([r.context()], [r.temperature])
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
        batch = self._expire_batch(batch)

        def admit_one(r):
            fault_point("serving.admit", requests=(r.id,))
            return slots.admit_one(r.context(), r.temperature)

        for i, r in enumerate(batch):
            try:
                try:
                    s = admit_one(r)
                except (_Halt, PagePoolExhausted, ValueError):
                    raise
                except BaseException as e:
                    if slots.poisoned:
                        raise
                    self.failures += 1
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
                    self._stall_admissions = True
                    break
                with self._cond:
                    self.rejected += 1
                r._finish(e)
                self._journal_retire(r)
            except ValueError as e:      # a prompt the table cannot hold
                with self._cond:
                    self.rejected += 1
                r._finish(e)
                self._journal_retire(r)
            except BaseException as e:
                self.failures += 1
                if slots.poisoned:
                    rest = [x for x in batch[i:]
                            if x is not r and not x.done.is_set()]
                    self._quarantine(r, e)
                    self._recover(list(self._inflight.values()) + rest, e)
                    return
                self._quarantine(r, e)
            else:
                self._admitted(r, s)

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
            heads = [w.prompt for w in itertools.islice(self._waiting, 2)]
        for prompt in heads:
            if left <= 0:
                break
            try:
                left -= slots.prefetch_prefix(prompt, left)
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
                    self.rejected += 1
                slots.retire(s)
                r._finish(error)
                self._journal_retire(r)
            return
        s = max(self._inflight, key=lambda s: self._inflight[s].id)
        with self._cond:
            r = self._inflight.pop(s)
        if slots.host_tier is not None:
            try:
                slots.preserve_stream(r.context(), s)
            except Exception:
                logger.exception("preempt page preserve failed (the stream "
                                 "will re-prefill)")
        slots.retire(s)
        self.preempted += 1
        logger.warning("page pool exhausted (%s); preempting request %d "
                       "(%d tokens delivered, will resume)", error, r.id,
                       len(r.tokens))
        with self._cond:
            self._waiting.appendleft(r)
        self._stall_admissions = True

    # ----------------------------------------------------------- delivery
    def _deliver_block(self, toks, pre_lengths):
        """Fan one block's token columns out to the in-flight requests,
        retiring EOS/max-token completions. A speculative manager commits
        a variable count a slot (``last_counts``): column ``s`` is read up
        to it. ``pre_lengths`` (slot lengths before the dispatch) bounds
        each column to the positions the slot can hold: a request reaching
        ``max_position`` is force-retired (``Request.truncated``)."""
        done = []
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
            self.generated_tokens += col.size
            if finished:
                done.append(s)
        for s in done:
            with self._cond:
                r = self._inflight.pop(s)
            self.slots.retire(s)
            self.retired += 1
            self._stall_admissions = False   # pages/slots freed
            self._ttft_sum += ((r.first_token_at - r.submitted_at)
                               if r.first_token_at is not None else 0.0)
            r._finish()
            self._journal_retire(r)

    # -------------------------------------------- cancel/deadline sweeps
    def _swept(self, r, err):
        r._finish(err)
        self._journal_retire(r)
        with self._cond:
            if isinstance(err, DeadlineExceededError):
                self.deadline_expired += 1
            else:
                self.cancelled += 1

    def _sweep_waiting_locked(self):
        """Drop cancelled/expired waiting requests (cond lock held)."""
        if not self._waiting:
            return
        now = time.perf_counter()
        dead = [r for r in self._waiting
                if r._cancelled or (r.deadline is not None
                                    and now >= r.deadline)]
        for r in dead:
            self._waiting.remove(r)
            if r._cancelled:
                self._swept(r, RequestCancelledError(
                    f"request {r.id} cancelled"))
            else:
                self._swept(r, DeadlineExceededError(
                    f"request {r.id} exceeded its deadline after "
                    f"{now - r.submitted_at:.3f}s in queue"))

    def _expire_batch(self, batch):
        """Re-check a popped admission batch at the prefill boundary: a
        request cancelled or expired meanwhile fails here, before any
        prefill is spent on it, and so does one that names an adapter.
        Returns the still-live batch."""
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
            elif r.adapter is not None:
                with self._cond:
                    self.rejected += 1
                r._finish(AdapterLoadError(
                    f"request {r.id} names adapter {r.adapter!r} but the "
                    f"engine has no adapter pool (BIGDL_TPU_LORA off)"))
                self._journal_retire(r)
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

    # ----------------------------------------------------------- recovery
    def _quarantine(self, r, err):
        logger.warning("quarantining poisoned request %d: %r", r.id, err)
        self.quarantined += 1
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
        # restore accounting needs one admission a request (the manager's
        # last_admit_* are per admission); otherwise window-sized batches
        count = self._snap is not None and slots.paged
        i = 0
        while i < len(reqs):
            take = 1 if count else min(slots.window, slots.free_slots())
            chunk = reqs[i:i + take]
            fault_point("serving.admit", requests=tuple(r.id for r in chunk))
            assigned = slots.admit([r.context() for r in chunk],
                                   [r.temperature for r in chunk])
            with self._cond:
                for r, s in zip(chunk, assigned):
                    self._inflight[s] = r
            for r in chunk:
                if count:
                    self._count_resume(r)
                self._consume_resume_cb(r)
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
        return list(self._inflight.values())

    def _recover(self, affected, error):
        """In-place recovery from a failed admission, chunk, reservation
        or step: reset the slot table, then group-bisect the affected
        requests: a group whose probe block fails is split until the
        poisoned request is alone and quarantined; everyone else resumes
        from their exact context. Past the recovery budget, or past ``2 n
        + 8`` probes, the loop gives up cleanly."""
        self.recoveries += 1
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
        self._limbo = []
        seen, victims = set(), []
        for r in pool:
            if r.id not in seen and not r.done.is_set():
                seen.add(r.id)
                victims.append(r)
        try:
            self.slots.reset()
        except Exception:
            logger.exception("slot-table reset failed during give-up")
        if handoff:
            logger.warning("handing %d request(s) to failover after %r",
                           len(victims), error)
            try:
                self._failover(victims, error)
                victims = []
            except Exception:
                logger.exception("failover handler failed; failing "
                                 "requests instead")
        err = EngineFailedError(f"serving engine failed: {error!r}")
        err.__cause__ = error
        for r in victims:
            r._finish(err)
            # failover victims stay live in the journal (they resubmit
            # elsewhere); only terminally failed ones retire
            self._journal_retire(r)
        raise _Halt
