"""Metrics registry: counters, gauges, histograms in one process-wide sink
(a copy of the JAX package's ``obs/metrics.py``: the same snapshot keys
and Prometheus textfile lines).

Thread-safe (instrument mutations take a per-registry lock), reached
only when observability is enabled (call sites guard with
``obs.enabled()``), and exported as a JSON :func:`snapshot` (published
atomically by :func:`write_snapshot`) or in the Prometheus
textfile-collector format (:func:`to_prometheus`).  Metric names are
dotted; labels are keyword pairs.  The snapshot carries the most recent
benchtime spread (``utils/benchtime.py``) and the cost-model drift report
(:mod:`~pencilarrays_tpu_torch.obs.drift`), which the Prometheus text
also exports as gauges.  Both exports first record the device seconds
of the card's spans still in flight (``obs/tracing.py``).
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, Optional, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "registry",
    "counter",
    "gauge",
    "histogram",
    "snapshot",
    "write_snapshot",
    "to_prometheus",
    "write_prometheus",
]


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


# -- Prometheus exposition-format helpers -----------------------------------
# (shared by the per-process exporter and the mesh aggregator's
# rank-labeled textfile — obs/aggregate.py)

def _prom_name(name: str, prefix: str = "pa") -> str:
    """Metric/label-name sanitation: the exposition format allows only
    ``[a-zA-Z_:][a-zA-Z0-9_:]*``; anything else becomes ``_`` so a
    dotted (or hostile) name can never break the line grammar."""
    import re

    out = re.sub(r"[^a-zA-Z0-9_]", "_", str(name))
    if prefix:
        out = prefix + "_" + out
    if not out or not (out[0].isalpha() or out[0] == "_"):
        out = "_" + out
    return out


def _prom_escape(value) -> str:
    """Label-VALUE escaping per the exposition format: backslash,
    double-quote and newline — a plan fingerprint containing ``"`` or
    ``\\n`` must not corrupt the textfile."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _prom_labels(labels: Dict[str, str],
                 extra: Optional[Dict[str, str]] = None) -> str:
    merged = dict(labels or {})
    if extra:
        # the Prometheus honor_labels=false convention: an injected
        # label (the mesh fold's publisher `rank`) wins the name, and a
        # colliding series-own label survives as `exported_<name>` —
        # `cluster.stragglers{rank=1}` published by rank 0 must not
        # lose WHICH rank was the straggler
        for k in list(merged):
            if k in extra:
                merged[f"exported_{k}"] = merged.pop(k)
        merged.update(extra)
    if not merged:
        return ""
    inner = ",".join(
        f'{_prom_name(k, prefix="")}="{_prom_escape(v)}"'
        for k, v in sorted(merged.items()))
    return "{" + inner + "}"


def _drift_prometheus_lines(report: dict, prefix: str = "pa",
                            extra: Optional[Dict[str, str]] = None,
                            seen_types: Optional[set] = None) -> list:
    """The drift report as gauges: per-hop ``<prefix>_drift{hop=...}``
    plus the two per-source-class fitted bandwidths.  ``seen_types``
    dedups ``# TYPE`` headers across repeated calls (the mesh fold
    calls this once per rank — a second TYPE line for the same metric
    is an exposition-format error that fails the whole scrape)."""
    lines = []
    if seen_types is None:
        seen_types = set()

    def type_line(n: str) -> None:
        if n not in seen_types:
            seen_types.add(n)
            lines.append(f"# TYPE {n} gauge")

    hops = (report or {}).get("hops") or {}
    drifted = [(h, e) for h, e in sorted(hops.items())
               if isinstance(e.get("drift"), (int, float))]
    if drifted:
        n = _prom_name("drift", prefix)
        type_line(n)
        for hop, e in drifted:
            ls = _prom_labels({"hop": hop, "source": e.get("source", "?")},
                              extra)
            lines.append(f"{n}{ls} {e['drift']:g}")
    for key, cls in (("fitted_bytes_per_s", "device"),
                     ("dispatch_fitted_bytes_per_s", "dispatch")):
        bw = (report or {}).get(key)
        if isinstance(bw, (int, float)):
            n = _prom_name("drift_fitted_bytes_per_s", prefix)
            type_line(n)
            lines.append(
                f"{n}{_prom_labels({'class': cls}, extra)} {bw:g}")
    return lines


class Counter:
    """Monotonic count (events, bytes, retries)."""

    __slots__ = ("name", "labels", "value", "_lock")

    def __init__(self, name: str, labels: Dict[str, str], lock):
        self.name = name
        self.labels = labels
        self.value = 0.0
        self._lock = lock

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "labels", "value", "_lock")

    def __init__(self, name: str, labels: Dict[str, str], lock):
        self.name = name
        self.labels = labels
        self.value: Optional[float] = None
        self._lock = lock

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)


class Histogram:
    """Streaming distribution: count/sum/min/max/last plus log2 buckets.

    Buckets are powers of two over ``[2**lo, 2**hi]`` seconds-ish scales
    (wide enough for nanosecond dispatches and minute-long saves), fixed
    so per-observation cost is one ``frexp`` + one increment — no
    allocation on the hot path.
    """

    __slots__ = ("name", "labels", "count", "total", "vmin", "vmax", "last",
                 "buckets", "_lock")

    LO, HI = -20, 12  # 2**-20 s ~ 1 us .. 2**12 s ~ 68 min

    def __init__(self, name: str, labels: Dict[str, str], lock):
        self.name = name
        self.labels = labels
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self.last: Optional[float] = None
        self.buckets = [0] * (self.HI - self.LO + 2)
        self._lock = lock

    def observe(self, v: float) -> None:
        v = float(v)
        if v > 0:
            e = math.frexp(v)[1]  # v in [2**(e-1), 2**e)
            i = min(max(e - self.LO, 0), len(self.buckets) - 1)
        else:
            i = 0
        with self._lock:
            self.count += 1
            self.total += v
            self.vmin = min(self.vmin, v)
            self.vmax = max(self.vmax, v)
            self.last = v
            self.buckets[i] += 1

    def mean(self) -> Optional[float]:
        return self.total / self.count if self.count else None


class MetricsRegistry:
    """Get-or-create instruments keyed on (kind, name, labels)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[tuple, object] = {}

    def _get(self, cls, name: str, labels: Dict[str, str]):
        key = (cls.__name__, name, _label_key(labels))
        m = self._metrics.get(key)
        if m is None:
            with self._lock:
                m = self._metrics.get(key)
                if m is None:
                    m = cls(name, dict(labels), self._lock)
                    self._metrics[key] = m
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(Histogram, name, labels)

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()

    # -- exporters ---------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-serializable dump of every instrument plus the drift
        report and the latest benchtime spread (noise floor).  Carries
        both the human-keyed maps (``name{k=v}`` display keys — the
        stable consumer format) and a structured ``series`` list with
        labels as dicts, which the mesh aggregator folds without
        re-parsing display keys (label VALUES may legally contain
        ``,``/``=``/``{`` — method reprs and plan fingerprints do)."""
        from ..utils.benchtime import last_spread
        from .drift import drift_report
        from .events import run_id
        from .tracing import drain_spans

        drain_spans()
        with self._lock:
            metrics = list(self._metrics.values())
        out = {"format": "pencilarrays-tpu-metrics", "version": 1,
               "run": run_id(), "t_wall": time.time(),
               "counters": {}, "gauges": {}, "histograms": {},
               "series": []}
        for m in metrics:
            key = m.name if not m.labels else (
                m.name + "{" + ",".join(
                    f"{k}={v}" for k, v in sorted(m.labels.items())) + "}")
            series = {"name": m.name,
                      "labels": {str(k): str(v)
                                 for k, v in sorted(m.labels.items())}}
            if isinstance(m, Counter):
                out["counters"][key] = m.value
                series.update(kind="counter", value=m.value)
            elif isinstance(m, Gauge):
                out["gauges"][key] = m.value
                series.update(kind="gauge", value=m.value)
            else:
                h = {
                    "count": m.count, "total": m.total, "mean": m.mean(),
                    "min": None if m.count == 0 else m.vmin,
                    "max": None if m.count == 0 else m.vmax,
                    "last": m.last,
                    # sparse distribution: upper bound 2**e -> count
                    "buckets_le_pow2": {
                        str(i + m.LO): c
                        for i, c in enumerate(m.buckets) if c},
                }
                out["histograms"][key] = h
                series.update(kind="histogram", **h)
            out["series"].append(series)
        out["benchtime"] = last_spread()
        out["drift"] = drift_report()
        return out

    def to_prometheus(self, prefix: str = "pa") -> str:
        """Prometheus textfile-collector exposition of the registry,
        plus the cost-model drift report as gauges.
        Names and label values go through the exposition-format
        escaping below — a label value carrying ``"`` or a newline
        (plan fingerprints, free-form hop labels) must corrupt neither
        the line it is on nor the lines after it."""
        from .tracing import drain_spans

        drain_spans()
        with self._lock:
            metrics = list(self._metrics.values())
        lines = []
        seen_types = set()
        for m in sorted(metrics, key=lambda m: m.name):
            n, ls = _prom_name(m.name, prefix), _prom_labels(m.labels)
            if isinstance(m, Counter):
                if n not in seen_types:
                    lines.append(f"# TYPE {n}_total counter")
                    seen_types.add(n)
                lines.append(f"{n}_total{ls} {m.value:g}")
            elif isinstance(m, Gauge):
                if m.value is None:
                    continue
                if n not in seen_types:
                    lines.append(f"# TYPE {n} gauge")
                    seen_types.add(n)
                lines.append(f"{n}{ls} {m.value:g}")
            else:
                if n not in seen_types:
                    lines.append(f"# TYPE {n} summary")
                    seen_types.add(n)
                lines.append(f"{n}_count{ls} {m.count}")
                lines.append(f"{n}_sum{ls} {m.total:g}")
        from .drift import drift_report

        lines.extend(_drift_prometheus_lines(drift_report(), prefix))
        return "\n".join(lines) + ("\n" if lines else "")


# the process-wide registry (one sink, like the reference's shared timer)
registry = MetricsRegistry()


def counter(name: str, **labels) -> Counter:
    return registry.counter(name, **labels)


def gauge(name: str, **labels) -> Gauge:
    return registry.gauge(name, **labels)


def histogram(name: str, **labels) -> Histogram:
    return registry.histogram(name, **labels)


def snapshot() -> dict:
    return registry.snapshot()


def write_snapshot(path: Optional[str] = None) -> Optional[str]:
    """Atomically publish the snapshot as JSON (default:
    ``<journal dir>/metrics.json``; no-op returning None when
    observability is disabled and no explicit path is given)."""
    import os

    from ..resilience.fsutil import atomic_write_json
    from .events import enabled, journal_dir

    if path is None:
        if not enabled():
            return None
        path = os.path.join(journal_dir(), "metrics.json")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    atomic_write_json(path, registry.snapshot())
    return path


def to_prometheus(prefix: str = "pa") -> str:
    return registry.to_prometheus(prefix)


def write_prometheus(path: str, prefix: str = "pa") -> str:
    """Atomically publish the textfile-collector exposition (atomic
    replace: node_exporter never scrapes a torn file)."""
    import os

    from ..resilience.fsutil import atomic_write_text

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    atomic_write_text(path, registry.to_prometheus(prefix))
    return path
