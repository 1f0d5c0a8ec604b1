"""Rolling-median step-time anomaly detector (the port of
``bigdl_tpu/obs/anomaly.py``).

A step slower than ``k`` x the rolling median — a feed stall, a flaky
host, a cold cache — increments a counter, sets a gauge, logs a warning
with the ratio and triggers a (rate-limited) flight-recorder dump, all
visible live at ``/metrics``. The control plane's ``AutoScaler`` feeds it
the windowed mean TTFT.

Knobs (constructor args, defaulted from env flags):
``BIGDL_TPU_ANOMALY_K`` (threshold multiple, default 3.0),
``BIGDL_TPU_ANOMALY_WINDOW`` (rolling window, default 64). Detection
starts after ``warmup`` samples, so slow first steps (kernel builds,
allocator warm-up) do not seed the median.
"""

from __future__ import annotations

import logging
from collections import deque

from bigdl_tpu_torch.obs import metrics as _metrics
from bigdl_tpu_torch.utils.flags import get_flag

logger = logging.getLogger("bigdl_tpu_torch.obs")


class StepTimeAnomalyDetector:
    """Feed per-step wall seconds to :meth:`observe`; it keeps a rolling
    median and flags steps exceeding ``k`` x it. One instance per
    training loop; series are labeled by ``loop`` so local/distributed
    runs coexist on one registry."""

    def __init__(self, loop="train", k=None, window=None, warmup=8,
                 registry=None):
        if k is None:
            k = get_flag("BIGDL_TPU_ANOMALY_K", 3.0, float)
        if window is None:
            window = get_flag("BIGDL_TPU_ANOMALY_WINDOW", 64, int)
        if k <= 1.0:
            raise ValueError(f"anomaly threshold k must be > 1, got {k}")
        self.k = float(k)
        self.warmup = int(warmup)
        self.samples = deque(maxlen=max(2, int(window)))
        reg = registry or _metrics.default_registry()
        labels = ("loop",)
        self._median = reg.gauge(
            "bigdl_step_time_median_seconds",
            "rolling-median training step wall time", labels).labels(loop)
        self._last = reg.gauge(
            "bigdl_step_time_seconds",
            "last observed training step wall time", labels).labels(loop)
        self._anomalies = reg.counter(
            "bigdl_step_time_anomalies_total",
            "steps slower than k x the rolling median", labels).labels(loop)
        self.loop = loop

    def median(self):
        if not self.samples:
            return None
        s = sorted(self.samples)
        n = len(s)
        mid = n // 2
        return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])

    def observe(self, seconds):
        """Record one step's wall seconds; returns True when flagged as
        an anomaly (also: counter bump + warn log)."""
        seconds = float(seconds)
        self._last.set(seconds)
        med = self.median()
        ready = len(self.samples) >= self.warmup
        self.samples.append(seconds)
        if med is not None:
            self._median.set(med)
        if not ready or med is None or med <= 0.0:
            return False
        if seconds > self.k * med:
            self._anomalies.inc()
            logger.warning(
                "step-time anomaly (%s): %.4fs is %.1fx the rolling "
                "median %.4fs (threshold %.1fx over %d samples)",
                self.loop, seconds, seconds / med, med, self.k,
                len(self.samples))
            # anomalies are exactly when the last-N-iterations picture
            # matters; the dump is rate-limited inside reqtrace
            from bigdl_tpu_torch.obs import reqtrace
            reqtrace.flight_dump(
                f"step-time anomaly ({self.loop}): {seconds:.4f}s vs "
                f"median {med:.4f}s")
            return True
        return False
