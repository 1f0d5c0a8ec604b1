"""Dispatch counters (the port's stand-in for ``bigdl_tpu/utils/
profiling.py`` ``DecodeCounters``).

PyTorch runs eagerly, so there are no trace/compile counts to keep: a
slot manager counts the work it dispatched (prefill chunks, decode
steps, copy-on-write page copies), the total of those dispatches, and
counts that are not dispatches (decode steps that sampled).
"""

from __future__ import annotations

import threading


class DispatchCounters:
    """Named integer counters plus ``dispatches``, safe to read from any
    thread (``engine.metrics()``) while the scheduler thread ticks them."""

    def __init__(self, *names):
        self._lock = threading.Lock()
        self._counts = {n: 0 for n in names}
        self._counts["dispatches"] = 0

    def tick(self, name, n=1):
        """Count ``n`` dispatches of kind ``name``."""
        with self._lock:
            self._counts[name] += n
            self._counts["dispatches"] += n

    def add(self, name, n=1):
        """Add ``n`` to the counter ``name`` (created at 0) without
        counting a dispatch."""
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n

    def __getitem__(self, name):
        with self._lock:
            return self._counts[name]

    def snapshot(self):
        with self._lock:
            return dict(self._counts)

    def reset(self):
        with self._lock:
            for k in self._counts:
                self._counts[k] = 0
