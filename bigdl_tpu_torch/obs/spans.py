"""Host-side span tracer: nested, thread-aware, Perfetto-exportable (the
port of ``bigdl_tpu/obs/spans.py``).

Dapper-style wall-time spans of the *host orchestration* around the
device work: serving's submit, prefill, prefill chunk, decode step and
snapshot pass. A span times the host, not the card: a CUDA launch
returns at once, so ``serve/step`` covers the step's launches and its one
token readback (which waits for the card), the same host section the
reference times around an asynchronous XLA dispatch. A span adds no
``torch.cuda.synchronize``: that would change what it measures and slow
serving. Device-internal truth stays with ``utils.profiling.trace``
(``torch.profiler``); these spans are its cheap always-on complement.

Usage::

    from bigdl_tpu_torch import obs

    with obs.span("serve/step", live=n):
        slots.step()                     # timed host section

    obs.record_span("train/feed", t_data, t0, step=n)   # after the fact

Spans land in a bounded ring buffer (``BIGDL_TPU_OBS_SPAN_CAPACITY``,
8192; old spans fall off, so a soak runs at O(capacity) memory) and
export as Chrome trace-event JSON — ``chrome://tracing`` /
https://ui.perfetto.dev load it directly, one track per thread (the
scheduler thread has its own). Nesting is also recorded explicitly
(``parent``/``depth`` per span, tracked per thread), so tests and text
tooling need no interval math.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

from bigdl_tpu_torch.obs import metrics as _metrics
from bigdl_tpu_torch.utils.flags import get_flag


class Span:
    """One closed span: name, [start, end) in tracer-epoch seconds,
    originating thread, explicit nesting, free-form attrs."""

    __slots__ = ("name", "start", "end", "thread_id", "thread_name",
                 "parent", "depth", "attrs")

    def __init__(self, name, start, end, thread_id, thread_name,
                 parent=None, depth=0, attrs=None):
        self.name = name
        self.start = start
        self.end = end
        self.thread_id = thread_id
        self.thread_name = thread_name
        self.parent = parent
        self.depth = depth
        self.attrs = attrs or {}

    @property
    def duration(self):
        return self.end - self.start

    def __repr__(self):
        return (f"Span({self.name!r}, {self.duration * 1e3:.3f} ms, "
                f"thread={self.thread_name!r}, depth={self.depth})")


class _SpanContext:
    """Class-based context manager for :meth:`SpanTracer.span` — a
    generator ``@contextmanager`` costs several microseconds per use in
    interpreter machinery alone, which matters for a per-step probe.
    The enabled check happens at ``__enter__`` (not construction) so a
    pre-built context still respects a later kill-switch flip."""

    __slots__ = ("_tracer", "_name", "_attrs", "_start")

    def __init__(self, tracer, name, attrs):
        self._tracer = tracer
        self._name = name
        self._attrs = attrs
        self._start = None

    def __enter__(self):
        if not _metrics._enabled:
            return self
        tracer = self._tracer
        stack = getattr(tracer._local, "stack", None)
        if stack is None:
            stack = tracer._local.stack = []
        self._start = time.perf_counter() - tracer.epoch_perf
        stack.append(self._name)
        return self

    def __exit__(self, exc_type, exc, tb):
        start, self._start = self._start, None
        if start is None:  # was disabled at __enter__
            return False
        tracer = self._tracer
        end = time.perf_counter() - tracer.epoch_perf
        stack = tracer._local.stack
        stack.pop()
        tracer._append(self._name, start, end,
                       parent=stack[-1] if stack else None,
                       depth=len(stack), attrs=self._attrs)
        return False


class SpanTracer:
    """Bounded ring buffer of :class:`Span`, with per-thread nesting
    stacks. All methods are thread-safe; recording is a clock read plus
    one locked deque append."""

    def __init__(self, capacity=None):
        if capacity is None:
            capacity = get_flag("BIGDL_TPU_OBS_SPAN_CAPACITY", 8192, int)
        self._lock = threading.Lock()
        self._buf = deque(maxlen=max(1, int(capacity)))
        self._local = threading.local()
        # epoch: perf_counter is monotonic but arbitrary-origin; anchor it
        # to wall time once so exported timestamps are interpretable
        self.epoch_perf = time.perf_counter()
        self.epoch_wall = time.time()

    # --------------------------------------------------------- recording --
    def span(self, name, **attrs):
        """Time a host section. Nesting is per-thread: a span opened while
        another is open on the same thread records it as its parent."""
        return _SpanContext(self, name, attrs)

    def record(self, name, start, end, **attrs):
        """Record an already-timed section (``time.time()`` or
        ``perf_counter`` values both work — anything monotonic enough
        that ``end - start`` is the duration). For instrumenting existing
        timed code without restructuring it; records at the current
        thread's nesting depth."""
        if not _metrics._enabled:
            return
        dur = max(0.0, end - start)
        now = time.perf_counter() - self.epoch_perf
        stack = getattr(self._local, "stack", None) or []
        self._append(name, now - dur, now,
                     parent=stack[-1] if stack else None,
                     depth=len(stack), attrs=attrs)

    def _append(self, name, start, end, parent, depth, attrs):
        t = threading.current_thread()
        s = Span(name, start, end, t.ident, t.name,
                 parent=parent, depth=depth, attrs=attrs)
        # lock-free: deque.append is atomic under the GIL, and this is
        # the per-step hot path.  The lock below only serializes reads
        # and capacity swaps against each other; an append racing
        # set_capacity can at worst land on the retiring deque (one
        # dropped span), which a resize is allowed to do anyway.
        self._buf.append(s)

    # ------------------------------------------------------------- reads --
    def spans(self):
        """Snapshot of the ring buffer, oldest first."""
        with self._lock:
            return list(self._buf)

    def __len__(self):
        with self._lock:
            return len(self._buf)

    @property
    def capacity(self):
        return self._buf.maxlen

    def clear(self):
        with self._lock:
            self._buf.clear()

    def set_capacity(self, capacity):
        """Resize the ring (keeps the newest spans that fit)."""
        with self._lock:
            self._buf = deque(self._buf, maxlen=max(1, int(capacity)))

    # ------------------------------------------------------------ export --
    def chrome_trace(self):
        """Chrome trace-event JSON (the ``/trace`` page content): complete
        ("ph":"X") events in microseconds, one track per thread, plus
        metadata ("M") events — ``thread_name`` so Perfetto shows the
        copier/scheduler/writer thread names instead of bare tids
        (covering live ``bigdl-tpu-*`` worker threads even before their
        first span lands), ``thread_sort_index`` pinning a stable
        name-sorted track order across exports, and ``process_name`` —
        drop the dict into https://ui.perfetto.dev or chrome://tracing
        as-is."""
        pid = os.getpid()
        events, threads = [], {}
        for s in self.spans():
            threads.setdefault(s.thread_id, s.thread_name)
            args = dict(s.attrs)
            if s.parent is not None:
                args["parent"] = s.parent
            events.append({
                "name": s.name, "cat": "host", "ph": "X",
                "ts": s.start * 1e6, "dur": s.duration * 1e6,
                "pid": pid, "tid": s.thread_id, "args": args,
            })
        # name every live bigdl-tpu worker thread too: a copier or
        # snapshot writer that has not recorded a span yet still gets a
        # labeled (empty) track instead of appearing later as a bare tid
        for t in threading.enumerate():
            if t.ident is not None and t.name.startswith("bigdl-tpu-"):
                threads.setdefault(t.ident, t.name)
        meta = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                 "args": {"name": tname}}
                for tid, tname in sorted(threads.items())]
        order = sorted(threads.items(), key=lambda kv: (kv[1], kv[0]))
        meta.extend({"name": "thread_sort_index", "ph": "M", "pid": pid,
                     "tid": tid, "args": {"sort_index": idx}}
                    for idx, (tid, _) in enumerate(order))
        meta.append({"name": "process_name", "ph": "M", "pid": pid,
                     "args": {"name": "bigdl_tpu_torch host"}})
        return {
            "traceEvents": meta + events,
            "displayTimeUnit": "ms",
            "otherData": {"epoch_unix_s": self.epoch_wall,
                          "producer": "bigdl_tpu_torch.obs"},
        }

    def export(self, path):
        """Write :meth:`chrome_trace` to ``path`` (Perfetto-loadable)."""
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path


# ------------------------------------------------------------ default tracer
_default = SpanTracer()


def default_tracer():
    """The process-global tracer every built-in span lands in."""
    return _default


def span(name, **attrs):
    """``with obs.span("serve/step", live=n): ...`` on the default
    tracer."""
    return _default.span(name, **attrs)


def record_span(name, start, end, **attrs):
    """Record an already-timed section on the default tracer."""
    _default.record(name, start, end, **attrs)
