"""EngineSupervisor: the self-healing wrapper around a ``ServingEngine``
(the port of ``bigdl_tpu/resilience/supervisor.py``).

The scheduler survives a poisoned request by quarantine and a transient
dispatch error by in-place recovery; some failures still end its loop: an
error storm past the recovery budget, a dispatch that never returns, a
card that no longer answers. The supervisor makes those survivable:

- a monitor thread watches the scheduler's heartbeat and thread: a dead
  loop, a ``failed`` scheduler, or a busy loop whose heartbeat is older
  than ``wedge_timeout_s`` (plus ``warmup_grace_s`` before the first
  token, plus ``restore_grace_s`` while the loop restores pages) triggers
  a restart;
- the scheduler's ``failover`` hook hands the supervisor every unfinished
  request when the loop gives up, so nothing fails while a restart can
  still save it;
- a restart abandons the old scheduler, builds a new engine with the
  caller's ``factory`` and resubmits the victims: the same ``Request``
  objects, re-prefilled from ``context()`` (prompt + delivered tokens), so
  streams stay attached and no token is delivered twice;
- restarts back off exponentially (``backoff_base_s`` doubling up to
  ``backoff_max_s``); more than ``max_restarts`` within
  ``restart_window_s`` trips the circuit breaker: outstanding victims
  fail with :class:`CircuitOpenError` and new submissions fast-reject
  until :meth:`reset_circuit`.

On the card a sticky CUDA error (an illegal address, a device-side
assert) poisons the whole process's CUDA context: every engine the
factory builds in the same process fails again, so the breaker trips
after ``max_restarts`` rebuilds instead of looping. Recovering from such
an error needs a new process.

An engine's kernels are built or loaded in its loop thread before the
loop's first heartbeat (``SlotManager.warm_kernels``), so the build never
counts against the wedge detector. The reference's obs instruments are
plain attributes here (``restarts``, ``resubmitted``,
``last_recovery_s``, :meth:`state`); the fleet's ``victim_sink`` is
ROADMAP queue A.8.
"""

from __future__ import annotations

import collections
import itertools
import logging
import threading
import time

from bigdl_tpu_torch.serving.scheduler import (EngineClosedError,
                                               EngineFailedError,
                                               QueueFullError)
from bigdl_tpu_torch.utils.flags import get_flag

logger = logging.getLogger("bigdl_tpu_torch.resilience")

STATE_SERVING = 0
STATE_RESTARTING = 1
STATE_OPEN = 2


class CircuitOpenError(RuntimeError):
    """The supervisor's restart budget is exhausted; submissions fast-fail
    until :meth:`EngineSupervisor.reset_circuit`."""


def _dedup(requests):
    """Unfinished requests, first occurrence of each id, in order."""
    seen, out = set(), []
    for r in requests:
        if r.id not in seen and not r.done.is_set():
            seen.add(r.id)
            out.append(r)
    return out


class EngineSupervisor:
    """Watchdog and restart loop over engines built by ``factory``, a
    zero-argument callable returning a ready ``ServingEngine``. Route
    submissions through :meth:`submit` / :meth:`generate`: they wait
    across a restart instead of surfacing the dying engine's error."""

    _ids = itertools.count()

    def __init__(self, factory, poll_interval_s=0.05, wedge_timeout_s=5.0,
                 warmup_grace_s=10.0, restore_grace_s=30.0,
                 backoff_base_s=0.05, backoff_max_s=2.0, max_restarts=5,
                 restart_window_s=60.0, submit_wait_s=10.0, label=None):
        self._factory = factory
        self.poll_interval_s = float(poll_interval_s)
        self.wedge_timeout_s = float(wedge_timeout_s)
        self.warmup_grace_s = float(warmup_grace_s)
        self.restore_grace_s = float(restore_grace_s)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self.max_restarts = int(max_restarts)
        self.restart_window_s = float(restart_window_s)
        self.submit_wait_s = float(submit_wait_s)
        self.label = (str(next(EngineSupervisor._ids)) if label is None
                      else str(label))
        self.restarts = 0
        self.resubmitted = 0
        self.last_recovery_s = None
        self._lock = threading.Lock()
        self._victims = []              # handed over by failover/abandon
        self._open = False
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._serving = threading.Event()
        self._restart_times = collections.deque()
        self.engine = self._build()
        self._serving.set()
        self._monitor = threading.Thread(target=self._watch,
                                         name="bigdl-tpu-torch-supervisor",
                                         daemon=True)
        self._monitor.start()

    # ------------------------------------------------------------- plumbing
    def _build(self):
        eng = self._factory()
        eng.scheduler._failover = self._on_failover
        return eng

    def _on_failover(self, victims, error):
        """From a dying scheduler loop: bank its unfinished requests and
        wake the monitor. A hand-off after the circuit opened fails at
        once (the watch loop skips open circuits)."""
        logger.warning("supervisor %s received %d victim(s) after %r",
                       self.label, len(victims), error)
        with self._lock:
            stranded = self._open
            if not stranded:
                self._victims.extend(victims)
        if stranded:
            self._fail(victims, CircuitOpenError(
                f"supervisor {self.label}: circuit open"), error)
            return
        self._serving.clear()
        self._wake.set()

    def state(self):
        """0 serving, 1 restarting, 2 circuit open."""
        if self._open:
            return STATE_OPEN
        return STATE_SERVING if self._serving.is_set() else STATE_RESTARTING

    # ---------------------------------------------------------------- watch
    def _watch(self):
        while not self._stop.is_set():
            self._wake.wait(self.poll_interval_s)
            self._wake.clear()
            if self._stop.is_set() or self._open:
                continue
            sch = self.engine.scheduler
            reason = None
            limit = self.wedge_timeout_s
            if sch.generated_tokens == 0:     # still warming up
                limit += self.warmup_grace_s
            if sch.restore_active:            # loading snapshot pages
                limit += self.restore_grace_s
            if not sch.is_alive() or sch.failed is not None:
                reason = f"decode loop down ({sch.failed!r})"
            elif sch._busy and sch.heartbeat_age() > limit:
                reason = (f"decode loop wedged (busy, heartbeat "
                          f"{sch.heartbeat_age():.1f}s old)")
            if reason is not None:
                self._restart(reason)
            else:
                # a dying loop's failover can land after the restart it
                # caused merged an empty bank: resubmit the late victims
                self._flush_victims()

    def _resubmit_all(self, requests):
        for r in requests:
            try:
                self.engine.resubmit(r)
                self.resubmitted += 1
            except Exception as e:
                logger.exception("resubmission of request %d failed", r.id)
                if not r.done.is_set():
                    r._finish(e)

    def _flush_victims(self):
        with self._lock:
            victims, self._victims = self._victims, []
        ordered = [r for r in victims if not r.done.is_set()]
        self._resubmit_all(ordered)
        if ordered:
            logger.warning("supervisor %s: %d late victim(s) resubmitted",
                           self.label, len(ordered))
        if not self._open:
            self._serving.set()

    def _restart(self, reason):
        now = time.monotonic()
        with self._lock:
            while (self._restart_times
                   and now - self._restart_times[0] > self.restart_window_s):
                self._restart_times.popleft()
            exhausted = len(self._restart_times) >= self.max_restarts
            if not exhausted:
                self._restart_times.append(now)
                n_recent = len(self._restart_times)
        if exhausted:
            self._trip(reason)
            return
        self._serving.clear()
        logger.warning("supervisor %s restarting engine: %s", self.label,
                       reason)
        old = self.engine
        victims = old.scheduler.abandon()
        with self._lock:
            victims = self._victims + victims
            self._victims = []
        # failover and abandon can both report a request: dedup, in
        # submission order
        ordered = _dedup(victims)
        # the abandoned loop exits at its next safe point; a wedged one
        # stays parked but never touches its requests again
        old.shutdown(drain=False, timeout=0.2)
        backoff = min(self.backoff_max_s,
                      self.backoff_base_s * (2 ** (n_recent - 1)))
        if self._stop.wait(backoff):
            return
        if self._open:
            self._fail(ordered, CircuitOpenError(
                f"supervisor {self.label}: circuit opened during restart"))
            return
        try:
            self.engine = self._build()
        except Exception:
            logger.exception("supervisor %s: engine factory failed; will "
                             "retry", self.label)
            with self._lock:
                self._victims = ordered + self._victims
            self._wake.set()
            return
        self.restarts += 1
        self._resubmit_all(ordered)
        self._serving.set()
        self.last_recovery_s = time.monotonic() - now
        logger.warning("supervisor %s: engine restored in %.3fs (restart "
                       "%d, %d request(s) resubmitted)", self.label,
                       self.last_recovery_s, self.restarts, len(ordered))

    def _trip(self, reason):
        """Open the circuit: fail everything outstanding, fast-reject new
        work. Flipping open and draining the bank under one lock hold
        means a concurrent ``_on_failover`` either lands in this drain or
        sees the open circuit and fails its victims itself."""
        err = CircuitOpenError(
            f"supervisor {self.label}: {self.max_restarts} restarts within "
            f"{self.restart_window_s}s exhausted the budget (last failure: "
            f"{reason})")
        logger.error("%s", err)
        with self._lock:
            self._open = True
            victims, self._victims = self._victims, []
        try:
            victims = victims + self.engine.scheduler.abandon()
        except Exception:
            logger.exception("supervisor %s: abandon at trip failed",
                             self.label)
        self._fail(victims, err, self.engine.scheduler.failed)
        self._serving.set()     # unblock submit waiters: they fast-fail

    @staticmethod
    def _fail(victims, err, cause=None):
        if cause is not None and err.__cause__ is None:
            err.__cause__ = cause
        for r in _dedup(victims):
            r._finish(err)

    def evacuate(self, join_timeout=0.5):
        """Stop serving without spending restart budget: open the circuit
        (new submissions fast-fail), abandon the live engine's scheduler,
        shut it down, and return every unfinished request (banked and
        abandoned, deduped in submission order) for the caller to adopt
        elsewhere; :meth:`reset_circuit` re-arms the supervisor."""
        with self._lock:
            self._open = True
            banked, self._victims = self._victims, []
        try:
            abandoned = self.engine.scheduler.abandon()
        except Exception:
            logger.exception("supervisor %s: abandon during evacuation "
                             "failed", self.label)
            abandoned = []
        try:
            self.engine.shutdown(drain=False, timeout=join_timeout)
        except Exception:
            logger.exception("supervisor %s: engine shutdown during "
                             "evacuation failed", self.label)
        self._serving.set()
        return _dedup(banked + abandoned)

    def reset_circuit(self):
        """Close the circuit (after the fault is fixed); the restart budget
        starts fresh."""
        with self._lock:
            self._restart_times.clear()
            self._open = False
        self._wake.set()

    # ---------------------------------------------------------------- serve
    def _through_restart(self, call, absorbs):
        """``call(engine)`` on the current engine; an ``absorbs`` error
        from an engine being replaced waits (up to ``submit_wait_s``) for
        the replacement and retries."""
        deadline = time.monotonic() + self.submit_wait_s
        while True:
            if self._open:
                raise CircuitOpenError(f"supervisor {self.label}: circuit "
                                       f"open")
            if self._stop.is_set():
                raise EngineClosedError("supervisor closed")
            eng = self.engine
            try:
                return call(eng)
            except absorbs:
                if self._open or self._stop.is_set():
                    raise
                if self.engine is eng:
                    self._serving.clear()
                self._wake.set()
                if not self._serving.wait(
                        max(0.0, deadline - time.monotonic())):
                    raise

    def submit(self, prompt, max_new_tokens, **kw):
        """Submit through the current engine, absorbing a restart."""
        return self._through_restart(
            lambda eng: eng.submit(prompt, max_new_tokens, **kw),
            EngineFailedError)

    def resubmit(self, request):
        """Adopt an unfinished ``Request`` into the current engine (it
        re-prefills from ``context()``), absorbing a restart like
        :meth:`submit`. An abandoned engine rejects with the base
        ``EngineClosedError``, which also waits for the replacement."""
        out = self._through_restart(lambda eng: eng.resubmit(request),
                                    EngineClosedError)
        self.resubmitted += 1
        return out

    def generate(self, prompt, max_new_tokens, timeout=None, **kw):
        """Submit + block, with the engine's queue retry and timeout
        cancel on top of the restart absorption."""
        retries = get_flag("BIGDL_TPU_QUEUE_RETRIES", 3, int)
        backoff = get_flag("BIGDL_TPU_QUEUE_RETRY_BACKOFF_S", 0.05, float)
        for attempt in range(retries + 1):
            try:
                handle = self.submit(prompt, max_new_tokens, **kw)
                break
            except QueueFullError:
                if attempt >= retries:
                    raise
                time.sleep(backoff * (2 ** attempt))
        try:
            return handle.result(timeout)
        except TimeoutError:
            handle.cancel()
            raise

    def result(self, handle, timeout=None):
        return handle.result(timeout)

    def cancel(self, handle):
        return handle.cancel()

    def metrics(self):
        """The current engine's metrics with ``supervisor_state``,
        ``engine_restarts``, ``supervisor_resubmitted`` and
        ``last_recovery_s``."""
        m = self.engine.metrics()
        m.update({"supervisor_state": self.state(),
                  "engine_restarts": self.restarts,
                  "supervisor_resubmitted": self.resubmitted,
                  "last_recovery_s": self.last_recovery_s})
        return m

    # ---------------------------------------------------------------- close
    def close(self, drain=True, timeout=None):
        """Stop supervising and shut the current engine down; banked
        victims fail with ``EngineClosedError``."""
        self._stop.set()
        self._wake.set()
        self._monitor.join(timeout=5.0)
        ok = self.engine.shutdown(drain=drain, timeout=timeout)
        with self._lock:
            victims, self._victims = self._victims, []
        self._fail(victims, EngineClosedError("supervisor closed"))
        return ok

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
