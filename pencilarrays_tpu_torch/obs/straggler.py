"""Straggler detection — which rank is dragging the collective.

On a pencil mesh every exchange runs at the pace of its slowest rank: a
thermally-throttled chip, a noisy ICI neighbor, or a host stuck in
page-cache writeback shows up as *every peer's* collectives slowing
down, and nothing in the per-process telemetry says **who**.  The
advanced-MPI FFT work (arXiv:1804.09536) adapts its decomposition from
measured per-stage timings, and DaggerFFT (arXiv:2601.12209) schedules
around measured worker skew — both need exactly this layer: per-hop,
per-rank duration statistics compared across the mesh.

Detection rule (:func:`detect`): for each hop label, each rank's
representative duration (the *minimum* over its dispatches — robust to
one-off compile/GC outliers) is compared against the **leave-one-out
median** of its peers.  A rank is flagged when its excess over that
baseline exceeds both

* ``min_excess_s`` — an absolute floor, so microsecond jitter on a
  2-rank drill mesh can never flag anyone, and
* ``z`` robust sigmas (``1.4826 * MAD`` of the peers), when at least
  two peers exist to estimate spread from (with a single peer the MAD
  is degenerate and the absolute floor alone governs).

Flags surface three ways: a fsync-critical ``cluster.straggler``
journal record naming the rank with its measured excess, a
``cluster.stragglers{rank=...}`` counter, and the offline path —
``pa-obs timeline`` runs :func:`detect_from_events` over a merged
journal so a post-mortem sees the same verdicts without any KV.
Deterministic drilling: the ``delay`` fault mode
(``hop.exchange:delay%rank1``, ``resilience/faults.py``) makes a chosen
rank drag every exchange by a fixed amount.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Set

__all__ = [
    "DEFAULT_Z",
    "DEFAULT_MIN_EXCESS_S",
    "detect",
    "hop_durations",
    "scan_snapshots",
    "detect_from_events",
]

DEFAULT_Z = 4.0
DEFAULT_MIN_EXCESS_S = 0.05


def _median(xs: List[float]) -> float:
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else (xs[n // 2 - 1] + xs[n // 2]) / 2.0


def detect(durations_by_rank: Dict[int, Dict[str, float]], *,
           z: float = DEFAULT_Z,
           min_excess_s: float = DEFAULT_MIN_EXCESS_S) -> List[dict]:
    """Flag stragglers from per-rank per-hop representative durations.

    Returns one flag dict per (hop, rank) —
    ``{hop, rank, duration_s, baseline_s, excess_s, z, peers}`` —
    sorted by excess, worst first.  Hops present on fewer than two
    ranks are skipped (nothing to compare)."""
    flags: List[dict] = []
    hops: Dict[str, Dict[int, float]] = {}
    for rank, durs in durations_by_rank.items():
        for hop, d in (durs or {}).items():
            if isinstance(d, (int, float)) and d >= 0:
                hops.setdefault(hop, {})[int(rank)] = float(d)
    for hop, per_rank in hops.items():
        if len(per_rank) < 2:
            continue
        for rank, d in per_rank.items():
            others = [v for r, v in per_rank.items() if r != rank]
            baseline = _median(others)
            excess = d - baseline
            if excess <= min_excess_s:
                continue
            mad = _median([abs(v - baseline) for v in others])
            sigma = 1.4826 * mad
            zscore = (excess / sigma) if sigma > 0 else None
            if zscore is not None and zscore <= z:
                continue
            flags.append({
                "hop": hop, "rank": rank,
                "duration_s": d, "baseline_s": baseline,
                "excess_s": excess, "z": zscore,
                "peers": sorted(r for r in per_rank if r != rank),
            })
    flags.sort(key=lambda f: -f["excess_s"])
    return flags


def hop_durations(snapshot: dict,
                  prev: Optional[dict] = None) -> Dict[str, float]:
    """A rank's representative per-hop durations from its metrics
    snapshot.  With ``prev`` (the same rank's snapshot from the
    previous fold tick), the representative is the **windowed mean**
    ``(Δtotal_s)/(Δcount)`` of the dispatches since then — so a rank
    that degrades *after* warming up (thermal throttling mid-job) still
    drifts its representative upward; the all-time minimum would hide
    it forever.  A hop with no new dispatches in the window is omitted
    (stale — nothing to judge).  Without ``prev`` (first fold, or the
    offline path) the all-time per-hop minimum is used — robust to
    one-off compile/GC outliers on a bounded run."""
    out: Dict[str, float] = {}
    hops = ((snapshot or {}).get("drift") or {}).get("hops") or {}
    prev_hops = ((prev or {}).get("drift") or {}).get("hops") or {}
    for hop, entry in hops.items():
        p = prev_hops.get(hop)
        if (p is not None and p.get("source") == entry.get("source")
                and isinstance(entry.get("total_s"), (int, float))
                and isinstance(p.get("total_s"), (int, float))):
            dn = (entry.get("count") or 0) - (p.get("count") or 0)
            dt = entry["total_s"] - p["total_s"]
            if dn <= 0:
                continue            # no new dispatches: stale hop
            d = dt / dn
        else:
            d = entry.get("measured_s")
        if isinstance(d, (int, float)) and d >= 0:
            out[hop] = float(d)
    return out


def scan_snapshots(snaps: Dict[int, dict], *,
                   prev: Optional[Dict[int, dict]] = None,
                   z: float = DEFAULT_Z,
                   min_excess_s: float = DEFAULT_MIN_EXCESS_S,
                   emit: bool = False,
                   seen: Optional[Set[tuple]] = None) -> List[dict]:
    """Detection over KV-published per-rank snapshots (the aggregator's
    fold path).  ``prev`` — the previous fold's snapshots — windows the
    durations (see :func:`hop_durations`) so late-onset degradation is
    caught.  With ``emit``, each NEW flag — deduplicated per
    (hop, rank) via ``seen``, so a cadence loop journals one event per
    straggler, not one per tick — lands as a fsync-critical
    ``cluster.straggler`` record plus a ``cluster.stragglers{rank}``
    counter bump."""
    prev = prev or {}
    flags = detect({r: hop_durations(s, prev.get(r))
                    for r, s in snaps.items()},
                   z=z, min_excess_s=min_excess_s)
    if not emit:
        return flags
    from . import events, metrics

    for f in flags:
        key = (f["hop"], f["rank"])
        if seen is not None:
            if key in seen:
                continue
            seen.add(key)
        metrics.counter("cluster.stragglers", rank=str(f["rank"])).inc()
        events.record_event(
            "cluster.straggler", rank=f["rank"], hop=f["hop"],
            excess_s=f["excess_s"], baseline_s=f["baseline_s"],
            duration_s=f["duration_s"], z=f["z"], peers=f["peers"])
    return flags


def detect_from_events(events: Iterable[dict], *,
                       z: float = DEFAULT_Z,
                       min_excess_s: float = DEFAULT_MIN_EXCESS_S
                       ) -> List[dict]:
    """Offline detection over a merged journal: per (rank, hop) the
    representative duration is the minimum ``dispatch_s`` of that
    rank's ``hop`` records — the same statistic the live path reads
    from the drift report, so online and post-mortem verdicts agree."""
    durs: Dict[int, Dict[str, float]] = {}
    for e in events:
        if e.get("ev") != "hop":
            continue
        d = e.get("dispatch_s")
        hop = e.get("hop") or e.get("method")
        if not isinstance(d, (int, float)) or d < 0 or hop is None:
            continue
        rank = int(e.get("proc", 0))
        cur = durs.setdefault(rank, {})
        cur[hop] = min(cur.get(hop, float("inf")), float(d))
    return detect(durs, z=z, min_excess_s=min_excess_s)
