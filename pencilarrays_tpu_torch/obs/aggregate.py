"""Live mesh aggregation — every rank's metrics, one artifact (the JAX
package's ``obs/aggregate.py``).

The metrics registry is per-process: N ranks write N ``metrics.json``
files that nobody joins at runtime.  This module rides a cluster KV
store (``set`` / ``get`` / ``try_get``, such as
:class:`~pencilarrays_tpu_torch.cluster.kv.FileKV`) to make the mesh
observable *live*:

* every rank publishes its full metrics snapshot (structured ``series``
  + drift report) under ``<ns>/obsagg/r<rank>`` on a cadence
  (:class:`MeshAggregator`, a daemon thread like the lease heartbeat);
* rank 0 folds the published snapshots into ``mesh_metrics.json``
  (counters summed, histograms merged — the ``TimerOutput.merge()``
  semantics: counts and totals add, min/max widen — gauges kept
  per-rank) and a mesh-wide Prometheus textfile whose every series
  carries a ``rank`` label;
* each fold also feeds the straggler detector
  (:mod:`~pencilarrays_tpu_torch.obs.straggler`) with the per-rank per-hop
  durations, so a dragging rank surfaces as a fsync-critical
  ``cluster.straggler`` event while the job runs;
* the first ticks run a **clock-offset exchange**: rank 0 republishes a
  wall-clock beacon, every other rank estimates its own offset as the
  *minimum* over ticks of ``own_wall_at_read - beacon_wall`` (the
  minimum squeezes out KV delivery delay) and journals it as a
  ``clock.sync`` record — the skew correction
  :mod:`~pencilarrays_tpu_torch.obs.timeline` prefers over marker estimation.

In the JAX package the cluster coordinator starts one when both the obs
and cluster layers are armed; the port's coordinator waits for
``cluster/`` (ROADMAP Queue 1 item 7(d)), so a caller builds and starts
:class:`MeshAggregator` itself.  ``PENCILARRAYS_TPU_OBS_AGG_S`` tunes the
cadence (seconds, default 10; ``0`` disables).  Everything is best-effort: KV weather
must never take down the job, and a missing rank's snapshot degrades
to a gap in the fold, never an exception.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

__all__ = [
    "AGG_CADENCE_VAR",
    "DEFAULT_CADENCE_S",
    "MeshAggregator",
    "fold_snapshots",
    "mesh_prometheus",
    "agg_cadence",
]

AGG_CADENCE_VAR = "PENCILARRAYS_TPU_OBS_AGG_S"
DEFAULT_CADENCE_S = 10.0


def agg_cadence() -> float:
    """Publish/fold cadence in seconds (0 = aggregation disabled;
    parsing lives in ``engine/config.py``)."""
    from ..engine import config as _rtc

    return _rtc.current().obs_agg_cadence


def fold_snapshots(snaps: Dict[int, dict], *,
                   world: Optional[int] = None) -> dict:
    """Fold per-rank snapshots into the mesh view.  Counter values sum
    across ranks, histograms merge (count/total add, min/max widen,
    buckets add — exactly how ``TimerOutput.merge()`` folds node
    counts/seconds), gauges stay per-rank (a last-write-wins value has
    no meaningful mesh sum).  Ranks whose snapshot is missing are
    listed, never silently absent."""
    ranks = sorted(snaps)
    world = world if world is not None else (max(ranks) + 1 if ranks else 0)
    out = {
        "format": "pencilarrays-tpu-mesh-metrics", "version": 1,
        "t_wall": time.time(),
        "ranks": ranks,
        "missing_ranks": [r for r in range(world) if r not in snaps],
        "counters": {}, "gauges": {}, "histograms": {},
        "per_rank": {str(r): snaps[r] for r in ranks},
    }
    for r in ranks:
        snap = snaps[r] or {}
        for key, v in (snap.get("counters") or {}).items():
            if isinstance(v, (int, float)):
                out["counters"][key] = out["counters"].get(key, 0) + v
        for key, v in (snap.get("gauges") or {}).items():
            out["gauges"].setdefault(key, {})[f"r{r}"] = v
        for key, h in (snap.get("histograms") or {}).items():
            if not isinstance(h, dict):
                continue
            m = out["histograms"].setdefault(key, {
                "count": 0, "total": 0.0, "min": None, "max": None,
                "buckets_le_pow2": {}})
            m["count"] += h.get("count", 0) or 0
            m["total"] += h.get("total", 0.0) or 0.0
            for bound in ("min", "max"):
                v = h.get(bound)
                if v is None:
                    continue
                cur = m[bound]
                m[bound] = v if cur is None else (
                    min(cur, v) if bound == "min" else max(cur, v))
            for b, c in (h.get("buckets_le_pow2") or {}).items():
                m["buckets_le_pow2"][b] = \
                    m["buckets_le_pow2"].get(b, 0) + c
    for h in out["histograms"].values():
        h["mean"] = (h["total"] / h["count"]) if h["count"] else None
    return out


def mesh_prometheus(snaps: Dict[int, dict], prefix: str = "pa") -> str:
    """The mesh-wide textfile exposition: every rank's series, each
    carrying a ``rank`` label (so one scrape shows per-rank skew, and
    ``sum by (...)`` recovers the mesh totals), including each rank's
    drift gauges.  Uses the snapshots' structured ``series`` (labels as
    dicts) — display keys are never re-parsed, so label values
    containing ``,``/``=`` cannot mis-split."""
    from .metrics import (_drift_prometheus_lines, _prom_labels,
                          _prom_name)

    lines: List[str] = []
    seen_types = set()
    for r in sorted(snaps):
        snap = snaps[r] or {}
        extra = {"rank": str(r)}
        for s in snap.get("series") or []:
            kind = s.get("kind")
            n = _prom_name(s.get("name", "_"), prefix)
            ls = _prom_labels(s.get("labels") or {}, extra)
            if kind == "counter":
                if n not in seen_types:
                    lines.append(f"# TYPE {n}_total counter")
                    seen_types.add(n)
                lines.append(f"{n}_total{ls} {float(s.get('value') or 0):g}")
            elif kind == "gauge":
                if s.get("value") is None:
                    continue
                if n not in seen_types:
                    lines.append(f"# TYPE {n} gauge")
                    seen_types.add(n)
                lines.append(f"{n}{ls} {float(s['value']):g}")
            elif kind == "histogram":
                if n not in seen_types:
                    lines.append(f"# TYPE {n} summary")
                    seen_types.add(n)
                lines.append(f"{n}_count{ls} {int(s.get('count') or 0)}")
                lines.append(f"{n}_sum{ls} {float(s.get('total') or 0):g}")
        lines.extend(_drift_prometheus_lines(snap.get("drift") or {},
                                             prefix, extra,
                                             seen_types=seen_types))
    return "\n".join(lines) + ("\n" if lines else "")


class MeshAggregator:
    """Per-rank publisher + (on rank 0) mesh folder over a cluster KV.

    Built by its caller over any KV with ``set`` / ``get`` /
    ``try_get`` (in the JAX package also by the cluster coordinator).
    ``start()`` runs the cadence loop on a daemon thread; every tick is
    best-effort and exception-free by construction."""

    def __init__(self, kv, rank: int, world: int, *,
                 cadence: Optional[float] = None,
                 namespace: str = "pa",
                 out_dir: Optional[str] = None):
        self.kv = kv
        self.rank = int(rank)
        self.world = int(world)
        self.cadence = float(cadence) if cadence else agg_cadence()
        self.ns = namespace
        self._out_dir = out_dir
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._clock_offset: Optional[float] = None
        self._clock_bound: Optional[float] = None
        self._clock_journaled_at: Optional[float] = None
        self._last_beacon_t: Optional[float] = None
        self._last_beacon_read: Optional[float] = None
        self._prev_snaps: Dict[int, dict] = {}
        self._straggler_seen: set = set()
        self._lock = threading.Lock()

    # a staleness bound above this is useless for skew correction (the
    # merger ignores offsets below their own bound, and real cross-host
    # skew worth correcting is far larger than a second)
    MAX_SAMPLE_BOUND_S = 1.0

    # -- keys --------------------------------------------------------------
    def _snap_key(self, rank: int) -> str:
        return f"{self.ns}/obsagg/r{rank}"

    def _beacon_key(self) -> str:
        return f"{self.ns}/obsagg/clock"

    # -- publishing --------------------------------------------------------
    def publish_once(self) -> bool:
        """Publish this rank's snapshot (one KV set); False on weather."""
        from . import metrics

        try:
            self.kv.set(self._snap_key(self.rank),
                        json.dumps(metrics.snapshot(), default=str))
            metrics.counter("obs.agg_publishes").inc()
            return True
        except Exception:
            return False

    # -- clock-offset exchange --------------------------------------------
    def sync_clock_once(self) -> Optional[float]:
        """One beacon round: rank 0 republishes its wall clock; other
        ranks sample ``read_wall - beacon_wall``.  A sample is taken
        ONLY when the beacon value *changed* since a recent previous
        read — then the publish happened inside that read gap, so the
        gap bounds the staleness error (a raw read of a stale beacon
        measures the publish/read phase difference, not skew).  The
        minimum over valid samples, with its error bound, is journaled
        as a ``clock.sync`` record (``bound_s``); the timeline merger
        ignores offsets smaller than their own bound, so an NTP-synced
        mesh is never "corrected" by boot stagger."""
        from . import events

        if self.rank == 0:
            try:
                self.kv.set(self._beacon_key(),
                            json.dumps({"t": time.time()}))
            except Exception:
                pass
            return 0.0
        try:
            raw = self.kv.try_get(self._beacon_key())
            if raw is None:
                return self._clock_offset
            beacon_t = float(json.loads(raw)["t"])
        except Exception:
            return self._clock_offset
        now = time.time()
        prev_t, prev_read = self._last_beacon_t, self._last_beacon_read
        self._last_beacon_t, self._last_beacon_read = beacon_t, now
        if (prev_t is None or beacon_t == prev_t or prev_read is None
                or now - prev_read > self.MAX_SAMPLE_BOUND_S):
            return self._clock_offset   # freshness unknown: no sample
        sample = now - beacon_t          # skew + delivery + (<= gap)
        bound = now - prev_read
        if self._clock_offset is None or sample < self._clock_offset:
            self._clock_offset = sample
            self._clock_bound = bound
        if events.enabled() and self._clock_offset is not None:
            improved = (self._clock_journaled_at is None
                        or self._clock_offset
                        < self._clock_journaled_at - 0.05)
            if improved:
                self._clock_journaled_at = self._clock_offset
                events.record_event(
                    "clock.sync", ref_rank=0,
                    offset_s=self._clock_offset,
                    bound_s=self._clock_bound, method="kv")
        return self._clock_offset

    # -- folding (rank 0) --------------------------------------------------
    def collect(self, *, wait: bool = False,
                timeout: float = 30.0) -> Tuple[Dict[int, dict], List[int]]:
        """Read every rank's published snapshot.  ``wait`` blocks (with
        ``timeout``) for ranks that have not published yet — the drill
        entry point; the cadence loop never waits (a missing rank is a
        fold gap, reported in ``missing_ranks``)."""
        snaps: Dict[int, dict] = {}
        missing: List[int] = []
        for r in range(self.world):
            try:
                if wait:
                    raw = self.kv.get(self._snap_key(r), timeout)
                else:
                    raw = self.kv.try_get(self._snap_key(r))
                snap = json.loads(raw) if raw is not None else None
            except Exception:
                snap = None
            if isinstance(snap, dict):
                snaps[r] = snap
            else:
                missing.append(r)
        return snaps, missing

    def fold_once(self, *, wait: bool = False,
                  timeout: float = 30.0) -> Optional[dict]:
        """Rank 0: collect + fold + publish ``mesh_metrics.json`` and
        ``mesh_metrics.prom`` next to the journal, then feed the
        straggler detector.  Returns the fold (None off rank 0)."""
        from ..resilience.fsutil import atomic_write_json, atomic_write_text
        from . import events, metrics
        from .straggler import scan_snapshots

        if self.rank != 0:
            return None
        snaps, missing = self.collect(wait=wait, timeout=timeout)
        fold = fold_snapshots(snaps, world=self.world)
        try:
            out_dir = self._out_dir or events.journal_dir()
            os.makedirs(out_dir, exist_ok=True)
            atomic_write_json(os.path.join(out_dir, "mesh_metrics.json"),
                              fold)
            atomic_write_text(os.path.join(out_dir, "mesh_metrics.prom"),
                              mesh_prometheus(snaps))
        except Exception:
            pass    # a full disk must not take down the fold loop
        metrics.counter("obs.agg_folds").inc()
        if events.enabled():
            events.record_event("obs.agg", status="fold",
                                ranks=sorted(snaps), missing=missing)
        with self._lock:
            # windowed against the previous fold's snapshots, so a rank
            # that degrades AFTER warming up still drifts its windowed
            # mean upward and gets flagged (the all-time min cannot)
            scan_snapshots(snaps, prev=self._prev_snaps, emit=True,
                           seen=self._straggler_seen)
            self._prev_snaps = dict(snaps)
        return fold

    # -- the cadence loop --------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        from ..engine.threads import spawn_thread

        self._thread = spawn_thread(self._loop,
                                    name=f"pa-obs-agg-r{self.rank}")

    def _loop(self) -> None:
        # alignment burst: both sides run a dense beacon window at
        # start, so whenever the ranks boot within a few seconds of
        # each other the readers get offset samples with a tight
        # (~0.2 s) freshness bound — the only samples worth journaling.
        # Publishing/folding rides ALONG on its own cadence (every
        # ceil(cadence/0.2) burst iterations, and once up front): the
        # burst must not delay the first mesh snapshot by 5 s, or a
        # short drill / sub-5 s cadence would never see the live path.
        publish_every = max(1, int(self.cadence / 0.2))
        for i in range(25):
            if self._stop.is_set():
                return
            try:
                self.sync_clock_once()
                if i % publish_every == 0:
                    self.publish_once()
                    if self.rank == 0:
                        self.fold_once(wait=False)
            except Exception:
                pass
            if self._stop.wait(min(0.2, self.cadence)):
                return
        ticks = 0
        while True:
            try:
                self.sync_clock_once()
                if (self.rank != 0 and self._clock_offset is None
                        and ticks % 10 == 9):
                    # the boot bursts missed each other: retry a short
                    # dense poll window to catch rank 0's next per-tick
                    # beacon refresh with a tight bound
                    for _ in range(10):
                        if self._stop.wait(0.2):
                            return
                        self.sync_clock_once()
                self.publish_once()
                if self.rank == 0:
                    self.fold_once(wait=False)
            except Exception:   # pragma: no cover - belt and braces:
                pass            # the loop must survive anything
            ticks += 1
            if self._stop.wait(self.cadence):
                return

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
        self._thread = None
