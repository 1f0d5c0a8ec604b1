"""SIGTERM / preemption guard for the training loops (the port of
``bigdl_tpu/resilience/preempt.py``).

A scheduler that preempts a job sends SIGTERM, and a loop that ignores it
loses every step since its last checkpoint trigger. The guard turns the
signal into a flag the optimizer loops poll between steps: on seeing it
they drain the dispatch-ahead queue (so the stored loss and ``neval`` are
current), write a final checkpoint, and raise :class:`TrainingPreempted`,
the one exception ``DistriOptimizer``'s retry loop lets through.

``Optimizer.optimize()`` arms the guard when ``BIGDL_TPU_PREEMPT_GUARD``
is on (default) and the loop runs on the main thread (CPython delivers
signals there only); elsewhere :func:`request` flags a preemption
directly, as the fault harness's ``preempt`` kind does. :func:`uninstall`
puts back the handler that :func:`install` replaced. The flag is
process-wide: :func:`clear` it before resuming in the same process.
"""

from __future__ import annotations

import logging
import signal
import threading
import time

logger = logging.getLogger("bigdl_tpu_torch.resilience")


class TrainingPreempted(RuntimeError):
    """Raised by the optimizer loop once the preemption checkpoint is on
    disk; ``neval`` is the checkpointed iteration."""

    def __init__(self, message, neval=None):
        super().__init__(message)
        self.neval = neval


class _Guard:
    def __init__(self):
        self._lock = threading.Lock()
        self._requested = False
        self._reason = None
        self._at = None
        self._installed = False
        self._prev = None

    def install(self):
        """Arm the SIGTERM handler (idempotent). Off the main thread this
        does nothing and returns False."""
        with self._lock:
            if self._installed:
                return True
            if threading.current_thread() is not threading.main_thread():
                return False
            self._prev = signal.signal(signal.SIGTERM, self._on_sigterm)
            self._installed = True
            return True

    def uninstall(self):
        """Put back the handler :meth:`install` replaced."""
        with self._lock:
            if not self._installed:
                return
            signal.signal(signal.SIGTERM, self._prev or signal.SIG_DFL)
            self._installed = False
            self._prev = None

    def _on_sigterm(self, signum, frame):
        self.request(reason="SIGTERM")

    def request(self, reason="requested"):
        """Flag a preemption (the signal handler, the fault harness or a
        caller)."""
        with self._lock:
            first = not self._requested
            self._requested = True
            self._reason = reason
            self._at = time.time()
        if first:
            from bigdl_tpu_torch import obs
            obs.counter("bigdl_preemptions_total",
                        "preemption requests observed by the guard").inc()
            logger.warning("preemption requested (%s): training will drain, "
                           "checkpoint, and exit at the next step boundary",
                           reason)

    def requested(self):
        return self._requested

    def reason(self):
        return self._reason

    def clear(self):
        with self._lock:
            self._requested = False
            self._reason = None
            self._at = None


_GUARD = _Guard()

install = _GUARD.install
uninstall = _GUARD.uninstall
request = _GUARD.request
requested = _GUARD.requested
reason = _GUARD.reason
clear = _GUARD.clear

__all__ = ["TrainingPreempted", "install", "uninstall", "request",
           "requested", "reason", "clear"]
