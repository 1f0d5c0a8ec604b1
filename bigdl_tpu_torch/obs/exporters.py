"""Telemetry exporters: HTTP endpoint, JSONL sink, summary bridge (the
port of ``bigdl_tpu/obs/exporters.py``).

Three ways out of the process, all stdlib:

- :class:`MetricsServer` — a background ``http.server`` endpoint serving
  ``/metrics`` (Prometheus text exposition — point a scraper at it),
  ``/metrics.json`` (the JSON snapshot), ``/trace`` (Chrome trace-event
  JSON of the host spans), ``/requests`` (request-timeline index;
  ``?trace=ID`` for one timeline, ``&fmt=perfetto`` for its Perfetto
  track), ``/healthz`` (liveness probes: 200 when every registered
  component reports healthy, 503 otherwise), and ``/profile?seconds=N``
  (an on-demand ``torch.profiler`` capture window, CUDA activity
  included when a card is present; returns the logdir at once, 409
  while a capture is already running). Daemon threads; ``port=0``
  picks a free port; it binds ``127.0.0.1`` unless told otherwise.
- :class:`JsonlSink` — append one registry snapshot per call to a
  ``.jsonl`` file (the batch-job analog of scraping).
- :class:`SummaryBridge` — mirror selected registry series into any
  writer with ``add_scalar(tag, value, step)`` (a TensorBoard
  ``SummaryWriter``, say).
"""

from __future__ import annotations

import json
import logging
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from bigdl_tpu_torch.obs import metrics as _metrics
from bigdl_tpu_torch.obs import reqtrace as _reqtrace
from bigdl_tpu_torch.obs import spans as _spans

logger = logging.getLogger("bigdl_tpu_torch.obs")


class MetricsServer:
    """Background HTTP endpoint over a registry + tracer (module
    docstring). ``with MetricsServer(port=9090) as srv: ...`` or keep a
    long-lived instance and ``close()`` it on shutdown."""

    def __init__(self, registry=None, tracer=None, recorder=None,
                 host="127.0.0.1", port=0):
        self.registry = registry or _metrics.default_registry()
        self.tracer = tracer or _spans.default_tracer()
        self.recorder = recorder or _reqtrace.default_recorder()
        self._profile_lock = threading.Lock()
        self._profile_active = False
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                path, _, query = self.path.partition("?")
                q = urllib.parse.parse_qs(query)
                status = 200
                if path in ("/metrics", "/metrics/"):
                    body = outer.registry.prometheus_text().encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif path in ("/metrics.json", "/snapshot"):
                    body = outer.registry.json().encode()
                    ctype = "application/json"
                elif path in ("/trace", "/trace/"):
                    body = json.dumps(outer.tracer.chrome_trace()).encode()
                    ctype = "application/json"
                elif path in ("/requests", "/requests/"):
                    doc, status = outer._requests_doc(
                        q.get("trace", [None])[0], q.get("fmt", [None])[0])
                    body = json.dumps(doc).encode()
                    ctype = "application/json"
                elif path in ("/healthz", "/healthz/"):
                    health = outer.registry.health()
                    ok = all(health.values())
                    status = 200 if ok else 503
                    body = json.dumps({"healthy": ok,
                                       "components": health}).encode()
                    ctype = "application/json"
                elif path in ("/profile", "/profile/"):
                    doc, status = outer._start_profile(
                        q.get("seconds", ["5"])[0])
                    body = json.dumps(doc).encode()
                    ctype = "application/json"
                elif path == "/":
                    body = (b"bigdl_tpu_torch.obs: /metrics (prometheus), "
                            b"/metrics.json (snapshot), /trace (perfetto), "
                            b"/requests (timelines), /healthz, "
                            b"/profile?seconds=N\n")
                    ctype = "text/plain"
                else:
                    self.send_error(404)
                    return
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):
                logger.debug("obs http: " + fmt, *args)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="bigdl-tpu-obs-http",
                                        daemon=True)
        self._thread.start()
        self.host, self.port = self._httpd.server_address[:2]
        logger.info("obs endpoint on http://%s:%d/metrics",
                    self.host, self.port)

    # ---------------------------------------------------- request timelines --
    def _requests_doc(self, trace, fmt):
        """Payload for ``/requests``: the timeline index, one timeline
        (``?trace=ID``), or its Perfetto export (``&fmt=perfetto``)."""
        if trace is None:
            return {"requests": self.recorder.snapshot()}, 200
        if fmt == "perfetto":
            doc = self.recorder.perfetto(trace)
            ok = any(e.get("ph") == "X" for e in doc["traceEvents"])
            return doc, (200 if ok else 404)
        timeline = self.recorder.timeline(trace)
        if timeline is None:
            return {"error": f"unknown trace {trace!r}"}, 404
        return timeline, 200

    # ---------------------------------------------------- profiler capture --
    def _start_profile(self, seconds):
        """Kick off one background ``torch.profiler`` capture window and
        return ``(payload, http_status)`` immediately — the trace
        (``trace.json``, host and, on a card, CUDA events) lands in the
        returned logdir once the window closes. 409 while a capture is
        already open (the profiler is a process singleton); a failed
        capture is logged and never takes the server down."""
        try:
            seconds = min(600.0, float(seconds))
            if not seconds > 0:
                raise ValueError(seconds)
        except (TypeError, ValueError):
            return {"error": f"bad seconds={seconds!r}"}, 400
        with self._profile_lock:
            if self._profile_active:
                return {"error": "capture already running"}, 409
            self._profile_active = True
        import tempfile
        logdir = tempfile.mkdtemp(prefix="bigdl_tpu_torch_profile_")

        def _capture():
            try:
                # lazy: obs stays stdlib at import; torch's profiler
                # only loads when a capture is actually requested
                from bigdl_tpu_torch.utils.profiling import trace as _trace
                with _trace(logdir):
                    time.sleep(seconds)
            except Exception:
                logger.exception("profiler capture failed (ignored)")
            finally:
                with self._profile_lock:
                    self._profile_active = False

        threading.Thread(target=_capture, name="bigdl-tpu-obs-profile",
                         daemon=True).start()
        return {"logdir": logdir, "seconds": seconds}, 200

    @property
    def url(self):
        return f"http://{self.host}:{self.port}"

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class JsonlSink:
    """Append-one-snapshot-per-call JSONL writer (module docstring).
    Each line: ``{"time": ..., "step": ..., "metrics": snapshot}``."""

    def __init__(self, path, registry=None):
        self.path = path
        self.registry = registry or _metrics.default_registry()
        self._lock = threading.Lock()

    def write(self, step=None):
        line = json.dumps({"time": time.time(), "step": step,
                           "metrics": self.registry.snapshot()},
                          sort_keys=True)
        with self._lock, open(self.path, "a") as f:
            f.write(line + "\n")
        return line


class SummaryBridge:
    """Mirror selected registry series into a writer (anything with
    ``add_scalar(tag, value, step)``).

    ``series`` selects metric names; each labeled series becomes one
    scalar tag ``name{k=v,...}``. Histograms export ``_count``/``_sum``
    and the p50/p99 estimates. Call :meth:`export` wherever a step
    number is in hand (e.g. next to the existing Loss writes)."""

    def __init__(self, writer, series, registry=None):
        self.writer = writer
        self.series = tuple(series)
        self.registry = registry or _metrics.default_registry()

    @staticmethod
    def _tag(name, labels):
        if not labels:
            return name
        inner = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
        return f"{name}{{{inner}}}"

    def export(self, step):
        snap = self.registry.snapshot()
        for name in self.series:
            fam = snap.get(name)
            if fam is None:
                continue
            for entry in fam["series"]:
                tag = self._tag(name, entry["labels"])
                if fam["type"] == "histogram":
                    self.writer.add_scalar(tag + "_count", entry["count"],
                                           step)
                    self.writer.add_scalar(tag + "_sum", entry["sum"], step)
                    for q in ("p50", "p99"):
                        if entry[q] is not None:
                            self.writer.add_scalar(f"{tag}_{q}", entry[q],
                                                   step)
                else:
                    self.writer.add_scalar(tag, entry["value"], step)
