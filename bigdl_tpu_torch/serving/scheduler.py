"""Iteration-level scheduler: FIFO admission, chunked prefill, token-step
loop, streaming (the port of ``bigdl_tpu/serving/scheduler.py``, paged
path).

Requests are admitted into free slots and retired on EOS/max-tokens at
block granularity (continuous batching): a new arrival waits only for a
free slot, never for someone else's whole generation.

Thread model: ONE scheduler thread owns the slot manager — every device
dispatch happens there (the thread sets the CUDA device it serves on).
``submit`` only appends to the bounded waiting deque under the condition
lock. A full queue rejects with :class:`QueueFullError`.

Failure model: page exhaustion is handled (a new request waits; a
decoding one is preempted and resumes later from its context). ANY other
exception in a prefill chunk or decode step fails every request in the
engine with that error — ``result()`` re-raises it — and the engine stops
accepting work. The reference's in-place recovery (rebuild the slot table,
re-place and bisect requests) is not ported yet (ROADMAP queue A): it
would also hide a faulting kernel. Requests carry optional deadlines and
support ``cancel()``, both enforced at block boundaries.
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

from bigdl_tpu_torch.serving.paging import PagePoolExhausted

logger = logging.getLogger("bigdl_tpu_torch.serving")


class QueueFullError(RuntimeError):
    """The waiting queue is at ``max_queue`` — backpressure; retry later."""


class EngineClosedError(RuntimeError):
    """The engine is shut down (or the request was cancelled by it)."""


class EngineFailedError(EngineClosedError):
    """A dispatch failed and the engine halted; new submissions fail."""


class RequestCancelledError(RuntimeError):
    """The request was cancelled; its slot has been freed."""


class DeadlineExceededError(RuntimeError):
    """The request's ``deadline_s`` elapsed before completion; its slot
    has been freed."""


_DONE = object()


class Request:
    """One generation request and its token stream: iterate it for
    streaming tokens, or call :meth:`result` to block for the full
    sequence. ``deadline_s`` is a wall-clock TTL from submission."""

    _ids = itertools.count()

    def __init__(self, prompt, max_new_tokens, temperature=0.0,
                 eos_token=None, deadline_s=None):
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
    """FIFO admission + iteration-level decode loop over a
    :class:`~bigdl_tpu_torch.serving.paging.PagedSlotManager` (see module
    docstring). Owns the background thread; built and shut down by
    ``ServingEngine``."""

    def __init__(self, slots, max_queue=64, admit_wait_s=0.0):
        self.slots = slots
        self.max_queue = int(max_queue)
        self.admit_wait_s = float(admit_wait_s)
        self._waiting = collections.deque()
        self._cond = threading.Condition()
        self._accepting = True
        self._drain = True
        self.failed = None
        self._inflight = {}        # slot -> Request (loop thread only)
        # a popped admission batch the loop holds outside _waiting and
        # _inflight: a failure must still finish it
        self._limbo = []
        self.admitted = 0
        self.rejected = 0
        self.retired = 0
        self.generated_tokens = 0
        self.step_seconds = 0.0
        self.cancelled = 0
        self.deadline_expired = 0
        self.failures = 0
        self.preempted = 0
        # after a preemption, hold new admissions until a retirement frees
        # pages (the evicted stream must not re-admit into the full pool)
        self._stall_admissions = False
        self._ttft_sum = 0.0
        self._thread = threading.Thread(target=self._loop,
                                        name="bigdl-tpu-torch-serving",
                                        daemon=True)
        self._thread.start()

    # -------------------------------------------------------- caller side
    def submit(self, request):
        """Enqueue a request (any thread). Raises ``EngineFailedError``
        after a failure, ``EngineClosedError`` after shutdown and
        ``QueueFullError`` at capacity."""
        with self._cond:
            if self.failed is not None:
                self.rejected += 1
                raise EngineFailedError(
                    f"serving engine failed: {self.failed!r}")
            if not self._accepting:
                self.rejected += 1
                raise EngineClosedError("engine is shut down")
            if len(self._waiting) >= self.max_queue:
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

    def shutdown(self, drain=True, timeout=None):
        """Stop accepting. ``drain=True`` serves everything queued and in
        flight first; ``drain=False`` fails it with ``EngineClosedError``.
        Joins the thread; returns False if it is still alive after
        ``timeout``."""
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

    # ----------------------------------------------------- scheduler loop
    def _loop(self):
        try:
            dev = self.slots.device
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
            self._serve()
        except Exception as e:   # nobody may hang on a dead loop
            logger.exception("serving loop failed; failing every request")
            self._fail_all(e)

    def _serve(self):
        slots = self.slots
        while True:
            batch = []
            with self._cond:
                while (self._accepting and not self._waiting
                       and not self._inflight):
                    self._cond.wait()
                if not self._accepting and not self._drain:
                    err = EngineClosedError("engine shut down")
                    while self._waiting:
                        self._waiting.popleft()._finish(err)
                    for s, r in list(self._inflight.items()):
                        slots.retire(s)
                        r._finish(err)
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
                self._limbo = batch
            self._sweep_inflight()
            if batch:
                self._admit_paged(batch)
            self._limbo = []
            if slots.pending_prefills():
                # ONE chunk dispatch per loop iteration, interleaved with
                # the decode block below
                slots.prefill_tick()
            if not self._inflight:
                continue
            if not any(slots.active[s] for s in self._inflight):
                continue           # everything in flight is prefilling
            try:
                slots.reserve_block()
            except PagePoolExhausted as e:
                self._preempt(e)
                continue
            pre_lengths = slots.lengths.copy()
            t0 = time.perf_counter()
            toks = slots.step()        # (steps_per_sync, max_slots)
            dt = time.perf_counter() - t0
            self.step_seconds += dt
            self._deliver_block(toks, pre_lengths)

    def _fail_all(self, error):
        """Terminal failure: finish EVERY outstanding request with
        ``error`` and stop accepting."""
        with self._cond:
            self._accepting = False
            self.failed = error
            self.failures += 1
            victims = (list(self._waiting) + list(self._limbo)
                       + list(self._inflight.values()))
            self._waiting.clear()
            self._inflight.clear()
        self._limbo = []
        seen = set()
        for r in victims:
            if r.id not in seen and not r.done.is_set():
                seen.add(r.id)
                r._finish(error)

    # ---------------------------------------------------------- admission
    def _admit_paged(self, batch):
        """Per-request page allocation + pending-prefill enqueue (host
        work only; ``prefill_tick`` dispatches the chunks). Exhaustion
        with other work holding the pool requeues the rest of the batch
        at the queue FRONT and stalls admission until a retirement; with
        the pool all to itself the request can never fit and fails
        typed."""
        slots = self.slots
        batch = self._expire_batch(batch)
        for i, r in enumerate(batch):
            try:
                s = slots.admit_one(r.context(), r.temperature)
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
            except ValueError as e:      # a prompt the table cannot hold
                with self._cond:
                    self.rejected += 1
                r._finish(e)
            else:
                with self._cond:
                    self._inflight[s] = r
                self.admitted += 1

    def _preempt(self, error):
        """Decode-time page exhaustion: preempt the NEWEST in-flight
        request — retire its slot (freeing its pages) and requeue it at
        the front with its delivered tokens intact, so older streams keep
        decoding. A lone stream that cannot reserve its next positions
        can never finish: it fails typed instead."""
        slots = self.slots
        if len(self._inflight) <= 1:
            for s, r in list(self._inflight.items()):
                with self._cond:
                    del self._inflight[s]
                    self.rejected += 1
                slots.retire(s)
                r._finish(error)
            return
        s = max(self._inflight, key=lambda s: self._inflight[s].id)
        with self._cond:
            r = self._inflight.pop(s)
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
        retiring EOS/max-token completions. ``pre_lengths`` (slot lengths
        before the dispatch) bounds each column to the positions the slot
        can hold: a request reaching ``max_position`` is force-retired
        (``Request.truncated``)."""
        done = []
        for s, r in self._inflight.items():
            if not self.slots.active[s]:
                continue           # still prefilling in chunks
            col = toks[:, s][:r.remaining()]
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

    # -------------------------------------------- cancel/deadline sweeps
    def _swept(self, r, err):
        r._finish(err)
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
