"""MetricsRegistry: labelled Counter/Gauge/Histogram with Prometheus output
(the port of ``bigdl_tpu/obs/metrics.py``; stdlib only, like the
reference's, and a copy of it: the port imports nothing of the JAX
package).

- :class:`Counter` — monotonically increasing (steps, records, bytes).
- :class:`Gauge` — last-write-wins level (queue depth, records/sec).
- :class:`Histogram` — fixed cumulative buckets + sum/count, with
  quantile *estimates* interpolated from the bucket boundaries (TTFT,
  step time) and per-bucket worst-recent exemplars (trace IDs).

Families are created against a :class:`MetricsRegistry` and carry label
*names*; ``family.labels(engine="3")`` binds label *values* and returns
the child the hot path mutates. Creation is get-or-create by metric
name, so instrument helpers stay idempotent across calls (and across
``ServingEngine`` instances, which distinguish themselves by an
``engine`` label instead of by family). Family names, label names, help
strings and bucket bounds are the reference's, so a dashboard over one
package reads the other.

Everything is thread-safe: family creation takes the registry lock,
child creation the family lock, and each child mutation its own lock —
the serving scheduler thread, the host tier's copier, the snapshot
writer and scrape threads never tear each other's reads.

The registry also accepts *collectors* — callables sampled at scrape
time — for values that already live somewhere else
(``utils.profiling.DispatchCounters`` publishes its dispatch count and
modelled cost this way) — and *probes*, the ``/healthz`` liveness map.

The kill switch (``BIGDL_TPU_OBS=0`` or :func:`set_enabled`) turns every
mutation into a no-op; registry-backed views read zeros while it is off.
"""

from __future__ import annotations

import bisect
import json
import math
import threading
import time

from bigdl_tpu_torch.utils.flags import get_flag

_enabled = get_flag("BIGDL_TPU_OBS", True, bool)


def enabled():
    """Is telemetry recording on? (``BIGDL_TPU_OBS``, default on.)"""
    return _enabled


def set_enabled(value):
    """Flip the process-wide telemetry kill switch at runtime; returns the
    previous value. While off, metric mutations and span recording are
    no-ops (registry-backed views read zeros)."""
    global _enabled
    prev, _enabled = _enabled, bool(value)
    return prev


# --------------------------------------------------------------- exposition
def _escape_label(value):
    """Prometheus label-value escaping: backslash, double-quote, newline."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(text):
    """HELP-line escaping: backslash and newline only."""
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_labels(labels):
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"' for k, v in labels)
    return "{" + inner + "}"


def _fmt_value(v):
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    return repr(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)


# ------------------------------------------------------------------ families
class _Family:
    """Base metric family: a name, label names, and labeled children."""

    typ = ""

    def __init__(self, registry, name, help="", labels=()):
        _validate_name(name)
        self.registry = registry
        self.name = name
        self.help = help
        self.labelnames = tuple(labels)
        for ln in self.labelnames:
            _validate_name(ln)
        self._lock = threading.Lock()
        self._children = {}
        if not self.labelnames:
            # an unlabeled family IS its only child: family.inc() just works
            self._children[()] = self._make_child()

    def labels(self, *values, **kv):
        """Bind label values -> the mutable child for that series."""
        if kv:
            if values:
                raise ValueError("pass label values positionally OR by "
                                 "keyword, not both")
            try:
                values = tuple(str(kv[k]) for k in self.labelnames)
            except KeyError as e:
                raise ValueError(
                    f"{self.name} expects labels {self.labelnames}") from e
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name} takes {len(self.labelnames)} label value(s) "
                f"{self.labelnames}, got {len(values)}")
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._children[values] = self._make_child()
            return child

    def _series(self):
        """[(label_pairs, child)] snapshot, label-sorted for stable output."""
        with self._lock:
            items = sorted(self._children.items())
        return [(tuple(zip(self.labelnames, vals)), child)
                for vals, child in items]

    # unlabeled convenience: delegate mutations to the sole child
    def _solo(self):
        if self.labelnames:
            raise ValueError(
                f"{self.name} is labeled {self.labelnames}; bind values "
                f"with .labels() first")
        return self._children[()]


def _validate_name(name):
    import re
    if not re.fullmatch(r"[a-zA-Z_:][a-zA-Z0-9_:]*", name):
        raise ValueError(f"invalid metric/label name {name!r}")


class _Value:
    """A lock-guarded float cell (one Counter/Gauge child)."""

    __slots__ = ("_lock", "_v")

    def __init__(self):
        self._lock = threading.Lock()
        self._v = 0.0

    @property
    def value(self):
        with self._lock:
            return self._v


class CounterChild(_Value):
    def inc(self, n=1):
        if not _enabled:
            return
        if n < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._v += n


class GaugeChild(_Value):
    def set(self, v):
        if not _enabled:
            return
        with self._lock:
            self._v = float(v)

    def inc(self, n=1):
        if not _enabled:
            return
        with self._lock:
            self._v += n

    def dec(self, n=1):
        self.inc(-n)


class Counter(_Family):
    typ = "counter"

    def _make_child(self):
        return CounterChild()

    def inc(self, n=1):
        self._solo().inc(n)

    @property
    def value(self):
        return self._solo().value


class Gauge(_Family):
    typ = "gauge"

    def _make_child(self):
        return GaugeChild()

    def set(self, v):
        self._solo().set(v)

    def inc(self, n=1):
        self._solo().inc(n)

    def dec(self, n=1):
        self._solo().dec(n)

    @property
    def value(self):
        return self._solo().value


# latency-shaped default: 1 ms .. ~100 s, log-spaced (Prometheus defaults)
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0)


# an exemplar sticks until a worse observation lands in its bucket or
# it goes stale — "worst recent", so a /requests drill-down from a p99
# bucket reaches the outlier that put it there, not merely the newest
_EXEMPLAR_TTL_S = 60.0


class HistogramChild:
    """Fixed-bucket cumulative histogram (one labeled series)."""

    __slots__ = ("_lock", "bounds", "_counts", "_sum", "_count",
                 "_exemplars")

    def __init__(self, bounds):
        self._lock = threading.Lock()
        self.bounds = bounds                  # finite upper bounds, sorted
        self._counts = [0] * (len(bounds) + 1)  # +1: the +Inf bucket
        self._sum = 0.0
        self._count = 0
        self._exemplars = {}          # bucket idx -> (value, trace, wall)

    def observe(self, v, exemplar=None):
        if not _enabled:
            return
        v = float(v)
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            if exemplar is not None:
                old = self._exemplars.get(i)
                now = time.time()
                if (old is None or v >= old[0]
                        or now - old[2] > _EXEMPLAR_TTL_S):
                    self._exemplars[i] = (v, str(exemplar), now)

    # ------------------------------------------------------------- reads --
    def snapshot(self):
        """(cumulative_counts_per_bound_plus_inf, sum, count) — one
        consistent read."""
        with self._lock:
            counts = list(self._counts)
            s, c = self._sum, self._count
        cum, acc = [], 0
        for n in counts:
            acc += n
            cum.append(acc)
        return cum, s, c

    @property
    def sum(self):
        with self._lock:
            return self._sum

    @property
    def count(self):
        with self._lock:
            return self._count

    def exemplars(self):
        """Per-bucket worst-recent exemplars, ``{le_label: {value,
        trace, time}}`` for buckets that have one. Surfaced through
        :meth:`MetricsRegistry.snapshot` / ``/metrics.json`` /
        ``/requests`` only — the Prometheus text page stays
        byte-stable."""
        with self._lock:
            items = sorted(self._exemplars.items())
        out = {}
        for i, (v, ex, t) in items:
            le = (_fmt_value(self.bounds[i]) if i < len(self.bounds)
                  else "+Inf")
            out[le] = {"value": v, "trace": ex, "time": t}
        return out

    def quantile(self, q):
        """Estimate the q-quantile by linear interpolation inside the
        containing bucket (the Prometheus ``histogram_quantile``
        estimator). None with no observations; values past the last
        finite bound clamp to it; q=0 returns the lower edge of the
        first non-empty bucket (the minimum's bucket, not a blanket
        0.0); a first bucket with a non-positive upper bound cannot
        interpolate from 0 and returns the bound itself."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        cum, _, count = self.snapshot()
        if count == 0:
            return None
        if q == 0.0:
            i = next(i for i, c in enumerate(cum) if c > 0)
            if i >= len(self.bounds):
                return self.bounds[-1] if self.bounds else None
            if i == 0:
                return min(0.0, self.bounds[0])
            return self.bounds[i - 1]
        rank = q * count
        for i, c in enumerate(cum):
            if c >= rank:
                if i >= len(self.bounds):      # the +Inf bucket
                    return self.bounds[-1] if self.bounds else None
                hi = self.bounds[i]
                if i == 0 and hi <= 0.0:
                    return hi
                lo = self.bounds[i - 1] if i else 0.0
                prev = cum[i - 1] if i else 0
                frac = (rank - prev) / max(c - prev, 1)
                return lo + (hi - lo) * frac
        return self.bounds[-1] if self.bounds else None


class Histogram(_Family):
    typ = "histogram"

    def __init__(self, registry, name, help="", labels=(),
                 buckets=DEFAULT_BUCKETS):
        bounds = sorted(float(b) for b in buckets if b != math.inf)
        if not bounds:
            raise ValueError("histogram needs at least one finite bucket "
                             "bound")
        self.bounds = tuple(bounds)
        super().__init__(registry, name, help=help, labels=labels)

    def _make_child(self):
        return HistogramChild(self.bounds)

    def observe(self, v, exemplar=None):
        self._solo().observe(v, exemplar=exemplar)

    def quantile(self, q):
        return self._solo().quantile(q)

    def exemplars(self):
        return self._solo().exemplars()

    @property
    def sum(self):
        return self._solo().sum

    @property
    def count(self):
        return self._solo().count


_TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


# ------------------------------------------------------------------ registry
class MetricsRegistry:
    """Named metric families + scrape-time collectors (module docstring)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families = {}
        self._collectors = []
        self._probes = []

    # ------------------------------------------------------ get-or-create --
    def _family(self, cls, name, help, labels, **kw):
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if not isinstance(fam, cls) \
                        or fam.labelnames != tuple(labels):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.typ}{fam.labelnames}; cannot re-register as "
                        f"{cls.typ}{tuple(labels)}")
                return fam
            fam = cls(self, name, help=help, labels=labels, **kw)
            self._families[name] = fam
            return fam

    def counter(self, name, help="", labels=()):
        return self._family(Counter, name, help, labels)

    def gauge(self, name, help="", labels=()):
        return self._family(Gauge, name, help, labels)

    def histogram(self, name, help="", labels=(), buckets=DEFAULT_BUCKETS):
        fam = self._family(Histogram, name, help, labels, buckets=buckets)
        if fam.bounds != tuple(sorted(
                float(b) for b in buckets if b != math.inf)):
            raise ValueError(
                f"histogram {name!r} already registered with buckets "
                f"{fam.bounds}")
        return fam

    def register_collector(self, fn):
        """Register a scrape-time sampler: ``fn() -> iterable of
        (name, labels_dict, value)`` gauge samples, or None to
        self-unregister (the weakref-collector idiom — see
        ``utils.profiling.DecodeCounters``)."""
        with self._lock:
            self._collectors.append(fn)
        return fn

    def unregister_collector(self, fn):
        with self._lock:
            if fn in self._collectors:
                self._collectors.remove(fn)

    def register_probe(self, fn):
        """Register a liveness probe: ``fn() -> {component: status}``
        (truthy = healthy; engines report their decode-loop liveness,
        fleets their per-replica health map) merged into
        :meth:`health` — the ``/healthz`` payload. Return None from the
        probe to self-unregister (the weakref idiom collectors use)."""
        with self._lock:
            self._probes.append(fn)
        return fn

    def unregister_probe(self, fn):
        with self._lock:
            if fn in self._probes:
                self._probes.remove(fn)

    def health(self):
        """Merged ``{component: truthy-healthy}`` from live probes;
        dead ones (returned None) are pruned. A probe that raises —
        an engine mid-rebuild — contributes an unhealthy marker
        instead of breaking the scrape."""
        with self._lock:
            probes = list(self._probes)
        out, dead = {}, []
        for fn in probes:
            try:
                got = fn()
            except Exception:
                got = {f"probe_error_{id(fn):x}": 0}
            if got is None:
                dead.append(fn)
                continue
            out.update(got)
        if dead:
            with self._lock:
                for fn in dead:
                    if fn in self._probes:
                        self._probes.remove(fn)
        return out

    def _collect(self):
        """{name: [(label_pairs, value)]} from live collectors; dead ones
        (returned None) are pruned."""
        with self._lock:
            collectors = list(self._collectors)
        out, dead = {}, []
        for fn in collectors:
            samples = fn()
            if samples is None:
                dead.append(fn)
                continue
            for name, labels, value in samples:
                out.setdefault(name, []).append(
                    (tuple(sorted(labels.items())), float(value)))
        if dead:
            with self._lock:
                for fn in dead:
                    if fn in self._collectors:
                        self._collectors.remove(fn)
        return out

    # ------------------------------------------------------------- output --
    def prometheus_text(self):
        """The text exposition format (``/metrics`` page content):
        ``# HELP`` / ``# TYPE`` headers, one line per series, histograms
        expanded to ``_bucket{le=...}`` / ``_sum`` / ``_count``."""
        lines = []
        with self._lock:
            families = sorted(self._families.items())
        for name, fam in families:
            if fam.help:
                lines.append(f"# HELP {name} {_escape_help(fam.help)}")
            lines.append(f"# TYPE {name} {fam.typ}")
            for label_pairs, child in fam._series():
                if fam.typ == "histogram":
                    cum, s, c = child.snapshot()
                    for bound, n in zip(fam.bounds, cum):
                        le = label_pairs + (("le", _fmt_value(bound)),)
                        lines.append(
                            f"{name}_bucket{_fmt_labels(le)} {n}")
                    inf = label_pairs + (("le", "+Inf"),)
                    lines.append(f"{name}_bucket{_fmt_labels(inf)} {c}")
                    lines.append(
                        f"{name}_sum{_fmt_labels(label_pairs)} "
                        f"{_fmt_value(s)}")
                    lines.append(
                        f"{name}_count{_fmt_labels(label_pairs)} {c}")
                else:
                    lines.append(f"{name}{_fmt_labels(label_pairs)} "
                                 f"{_fmt_value(child.value)}")
        for name, samples in sorted(self._collect().items()):
            lines.append(f"# TYPE {name} gauge")
            for label_pairs, value in samples:
                lines.append(f"{name}{_fmt_labels(label_pairs)} "
                             f"{_fmt_value(value)}")
        return "\n".join(lines) + "\n"

    def snapshot(self):
        """JSON-ready dict of every series: counters/gauges carry
        ``value``, histograms carry ``count``/``sum``/``buckets`` plus
        p50/p90/p99 estimates; collector samples ride along as gauges."""
        out = {}
        with self._lock:
            families = sorted(self._families.items())
        for name, fam in families:
            series = []
            for label_pairs, child in fam._series():
                entry = {"labels": dict(label_pairs)}
                if fam.typ == "histogram":
                    cum, s, c = child.snapshot()
                    entry.update(
                        count=c, sum=s,
                        buckets={_fmt_value(b): n
                                 for b, n in zip(fam.bounds, cum)},
                        p50=child.quantile(0.5), p90=child.quantile(0.9),
                        p99=child.quantile(0.99))
                    ex = child.exemplars()
                    if ex:
                        entry["exemplars"] = ex
                else:
                    entry["value"] = child.value
                series.append(entry)
            out[name] = {"type": fam.typ, "help": fam.help, "series": series}
        for name, samples in sorted(self._collect().items()):
            out[name] = {"type": "gauge", "help": "(collector)",
                         "series": [{"labels": dict(lp), "value": v}
                                    for lp, v in samples]}
        return out

    def json(self):
        return json.dumps({"time": time.time(),
                           "metrics": self.snapshot()}, sort_keys=True)


# ------------------------------------------------------------ default registry
_default = MetricsRegistry()


def default_registry():
    """The process-global registry every built-in instrument lives on."""
    return _default


def counter(name, help="", labels=()):
    return _default.counter(name, help=help, labels=labels)


def gauge(name, help="", labels=()):
    return _default.gauge(name, help=help, labels=labels)


def histogram(name, help="", labels=(), buckets=DEFAULT_BUCKETS):
    return _default.histogram(name, help=help, labels=labels,
                              buckets=buckets)
