"""Request-scoped timelines + the flight recorder (the port of
``bigdl_tpu/obs/reqtrace.py``).

The span tracer (obs/spans.py) answers "what is each *thread* doing";
aggregate histograms answer "how is the *engine* doing". This module adds
the third leg, one request's journey:

- :class:`ReqTraceRecorder` — a bounded ring of structured lifecycle
  events per trace ID (submit, admit, token blocks with stream offsets,
  preemption, quarantine, failure, retire). Trace IDs are minted at
  ``ServingEngine.submit`` and ride the ``Request`` handle and the
  request journal, so a supervisor's resubmission or a journal's replay
  *continues* the same timeline. Exportable as Perfetto tracks, one
  track per request, via :meth:`ReqTraceRecorder.perfetto`.
- :class:`FlightRecorder` — per-engine rings of the last N scheduler
  iterations plus loose events (host-tier swaps, preemptions).
  ``dump()`` writes rings + request timelines to
  ``BIGDL_TPU_FLIGHT_DIR`` (default a folder under the temporary
  directory) when the anomaly detector fires, the supervisor restarts an
  engine, or on SIGUSR2 — the post-incident "what was the engine doing"
  artifact.

Everything is host-side stdlib, gated by ``BIGDL_TPU_REQ_TRACE``
(default on) on top of the global ``BIGDL_TPU_OBS`` kill switch: with
either off, recording is a no-op. The SIGUSR2 handler chains to the one
installed before it, so the reference's and the port's recorders both
dump when both packages share a process.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import threading
import time

from bigdl_tpu_torch.obs import metrics as _metrics
from bigdl_tpu_torch.utils.flags import get_flag

logger = logging.getLogger("bigdl_tpu_torch.obs")

_trace_on = get_flag("BIGDL_TPU_REQ_TRACE", True, bool)


def enabled():
    """Is request tracing recording? (``BIGDL_TPU_REQ_TRACE`` on AND the
    global obs kill switch on.)"""
    return _trace_on and _metrics._enabled


def set_enabled(value):
    """Flip request tracing at runtime; returns the previous value.
    (The obs kill switch still vetoes recording while off.)"""
    global _trace_on
    prev, _trace_on = _trace_on, bool(value)
    return prev


def mint():
    """A fresh 16-hex-char trace ID (process-unique, cheap)."""
    return os.urandom(8).hex()


class _TraceRing:
    """One trace's bounded event ring + identity metadata."""

    __slots__ = ("trace", "request_id", "started", "events", "dropped")

    def __init__(self, trace, capacity):
        self.trace = trace
        self.request_id = None
        self.started = time.time()
        self.events = collections.deque(maxlen=capacity)
        self.dropped = 0


class ReqTraceRecorder:
    """Bounded per-request lifecycle rings keyed by trace ID.

    ``capacity`` bounds events per trace (oldest fall off, counted in
    ``dropped``); ``max_traces`` bounds distinct traces held (LRU by
    last event — a retired request's timeline survives until newer
    traffic ages it out, which is what lets a TTFT exemplar resolve to
    its full timeline minutes later). Recording is one lock + deque
    append; timestamps are wall-clock so events recorded by different
    replicas of one migrated stream interleave on a single axis.
    """

    def __init__(self, capacity=None, max_traces=1024):
        if capacity is None:
            capacity = get_flag("BIGDL_TPU_REQ_TRACE_CAPACITY", 256, int)
        self.capacity = max(1, int(capacity))
        self.max_traces = max(1, int(max_traces))
        self._lock = threading.Lock()
        self._traces = collections.OrderedDict()

    # --------------------------------------------------------- recording --
    def event(self, trace, name, **attrs):
        """Record one lifecycle event on ``trace`` (no-op when tracing
        is off or ``trace`` is None — the flag-off fast path)."""
        if trace is None or not enabled():
            return
        now = time.time()
        with self._lock:
            ring = self._traces.get(trace)
            if ring is None:
                ring = self._traces[trace] = _TraceRing(trace,
                                                        self.capacity)
                while len(self._traces) > self.max_traces:
                    self._traces.popitem(last=False)
            else:
                self._traces.move_to_end(trace)
            rid = attrs.get("request")
            if rid is not None and ring.request_id is None:
                ring.request_id = rid
            if len(ring.events) == ring.events.maxlen:
                ring.dropped += 1
            ring.events.append((now, name, attrs))

    # ------------------------------------------------------------- reads --
    def traces(self):
        with self._lock:
            return list(self._traces)

    def __len__(self):
        with self._lock:
            return len(self._traces)

    def timeline(self, trace):
        """The trace's events oldest-first as dicts, or None when the
        trace is unknown (never recorded, or aged out of the LRU)."""
        with self._lock:
            ring = self._traces.get(trace)
            if ring is None:
                return None
            events = list(ring.events)
            rid, dropped = ring.request_id, ring.dropped
        out = []
        for t, name, attrs in events:
            e = {"t": t, "event": name}
            e.update(attrs)
            out.append(e)
        return {"trace": trace, "request": rid, "dropped": dropped,
                "events": out}

    def snapshot(self):
        """Index of every held trace (the ``/requests`` listing):
        ``{trace: {request, events, first, last, dropped}}``."""
        with self._lock:
            rings = list(self._traces.values())
        out = {}
        for ring in rings:
            events = list(ring.events)
            out[ring.trace] = {
                "request": ring.request_id,
                "events": len(events),
                "dropped": ring.dropped,
                "first": events[0][1] if events else None,
                "last": events[-1][1] if events else None,
                "start": events[0][0] if events else ring.started,
                "end": events[-1][0] if events else ring.started,
            }
        return out

    def clear(self):
        with self._lock:
            self._traces.clear()

    # ------------------------------------------------------------ export --
    def perfetto(self, trace=None):
        """Chrome trace-event JSON with ONE TRACK PER REQUEST: each
        trace becomes a synthetic thread whose name carries the request
        id + trace id, its lifetime a complete ("X") slice from first
        to last event, each lifecycle event an instant ("i") mark.
        Load in https://ui.perfetto.dev as-is. ``trace`` narrows the
        export to one request."""
        pid = os.getpid()
        with self._lock:
            rings = ([self._traces[trace]] if trace in self._traces
                     else [] if trace is not None
                     else list(self._traces.values()))
            rings = [(r.trace, r.request_id, list(r.events))
                     for r in rings]
        meta, events = [], []
        for tid, (tr, rid, evs) in enumerate(rings, start=1):
            label = (f"req {rid} [{tr}]" if rid is not None
                     else f"trace {tr}")
            meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                         "tid": tid, "args": {"name": label}})
            if not evs:
                continue
            t0, t1 = evs[0][0], evs[-1][0]
            closed = evs[-1][1] == "retire"
            events.append({"name": "lifetime" if closed
                           else "lifetime (open)",
                           "cat": "request", "ph": "X",
                           "ts": t0 * 1e6,
                           "dur": max(1.0, (t1 - t0) * 1e6),
                           "pid": pid, "tid": tid,
                           "args": {"trace": tr, "request": rid}})
            for t, name, attrs in evs:
                events.append({"name": name, "cat": "request",
                               "ph": "i", "s": "t",
                               "ts": t * 1e6, "pid": pid, "tid": tid,
                               "args": dict(attrs)})
        meta.append({"name": "process_name", "ph": "M", "pid": pid,
                     "args": {"name": "bigdl_tpu_torch requests"}})
        return {"traceEvents": meta + events, "displayTimeUnit": "ms",
                "otherData": {"producer": "bigdl_tpu_torch.obs.reqtrace"}}


class FlightRecorder:
    """Last-N scheduler iterations per engine + loose engine events,
    dumped to disk on anomaly / restart / SIGUSR2 (module docstring).

    ``note_iteration``/``note_event`` are loop-thread cheap (deque
    append under one lock). ``dump`` is rate-limited by
    ``min_interval_s`` so an anomaly storm produces one artifact, not
    thousands; it never raises (a full disk must not fail serving).
    """

    def __init__(self, iterations=64, directory=None, min_interval_s=5.0):
        self.iterations = max(1, int(iterations))
        self._dir = directory
        self.min_interval_s = float(min_interval_s)
        self._lock = threading.Lock()
        self._rings = {}
        self._last_dump = 0.0
        self.dumps = 0

    def _resolve_dir(self):
        d = self._dir or get_flag("BIGDL_TPU_FLIGHT_DIR")
        if d is None:
            import tempfile
            d = os.path.join(tempfile.gettempdir(), "bigdl_tpu_torch_flight")
        return d

    # --------------------------------------------------------- recording --
    def note_iteration(self, engine, **fields):
        """Record one scheduler-iteration summary for ``engine``."""
        if not enabled():
            return
        rec = dict(fields)
        rec["t"] = time.time()
        with self._lock:
            ring = self._rings.get(engine)
            if ring is None:
                ring = self._rings[engine] = collections.deque(
                    maxlen=self.iterations)
            ring.append(rec)

    def note_event(self, engine, event, **attrs):
        """Record a loose engine-scoped event (host-tier swap, restart,
        adapter load) into the same ring as the iterations."""
        if not enabled():
            return
        rec = dict(attrs)
        rec["t"] = time.time()
        rec["event"] = event
        with self._lock:
            ring = self._rings.get(engine)
            if ring is None:
                ring = self._rings[engine] = collections.deque(
                    maxlen=self.iterations)
            ring.append(rec)

    def snapshot(self):
        with self._lock:
            return {eng: list(ring) for eng, ring in self._rings.items()}

    # -------------------------------------------------------------- dump --
    def dump(self, reason, recorder=None, force=False):
        """Write the rings + every request timeline to one JSON file
        under the flight directory. Returns the path, or None when
        disabled/rate-limited/failed."""
        if not enabled():
            return None
        now = time.time()
        with self._lock:
            if not force and now - self._last_dump < self.min_interval_s:
                return None
            self._last_dump = now
        rec = recorder or default_recorder()
        doc = {
            "time": now,
            "reason": str(reason),
            "iterations": self.snapshot(),
            "requests": {tr: rec.timeline(tr) for tr in rec.traces()},
        }
        try:
            d = self._resolve_dir()
            os.makedirs(d, exist_ok=True)
            slug = "".join(c if c.isalnum() else "-"
                           for c in str(reason))[:48].strip("-") or "dump"
            path = os.path.join(d, f"flight-{now:.3f}-{slug}.json")
            with open(path, "w") as f:
                json.dump(doc, f)
        except OSError:
            logger.exception("flight-recorder dump failed (ignored)")
            return None
        with self._lock:
            self.dumps += 1
        logger.warning("flight recorder dumped to %s (%s)", path, reason)
        return path


# ---------------------------------------------------------------- defaults
_recorder = ReqTraceRecorder()
_flight = FlightRecorder()


def default_recorder():
    """The process-global request-timeline recorder."""
    return _recorder


def default_flight():
    """The process-global flight recorder."""
    return _flight


def event(trace, name, **attrs):
    """Record one lifecycle event on the default recorder."""
    _recorder.event(trace, name, **attrs)


def flight_dump(reason, force=False):
    """Trigger a flight-recorder dump on the default instances."""
    return _flight.dump(reason, recorder=_recorder, force=force)


def _install_sigusr2():
    """Best-effort: SIGUSR2 -> flight dump (main thread only; the
    default SIGUSR2 action is process death, so installing a handler
    only ever makes the process safer)."""
    import signal
    if not hasattr(signal, "SIGUSR2"):
        return False
    try:
        prev = signal.getsignal(signal.SIGUSR2)

        def _handler(signum, frame):
            flight_dump("SIGUSR2", force=True)
            if callable(prev):
                prev(signum, frame)

        signal.signal(signal.SIGUSR2, _handler)
        return True
    except (ValueError, OSError):       # non-main thread / exotic host
        return False


_sigusr2_installed = _install_sigusr2()
