"""Cross-rank timeline reconstruction — N journals, one story.

Every rank's flight recorder is an island: ``journal.r<p>.jsonl`` (plus
rotated ``journal.r<p>.<k>.jsonl`` segments) with per-process sequence
numbers and that host's wall clock.  A post-mortem needs the *mesh*
view: which rank's hop dragged the step, which verdict the epoch
advance belongs to, what rank 1 was doing while rank 0 restored.  This
module builds it:

* :func:`merge_journals` — read every rank's segments (in rotation
  order), tolerate wreckage (torn final lines, empty files, missing
  ranks — each degrades to a *warning*, never an exception or a
  silently dropped rank), correct cross-host clock skew, and k-way
  merge into one causally-ordered event list that preserves each
  rank's append order exactly.
* skew correction — each rank's wall clock is shifted by an offset
  against a reference rank, taken from ``clock.sync`` records (the KV
  clock-offset exchange of :mod:`~pencilarrays_tpu_torch.obs.aggregate`)
  when present, else *estimated* by aligning the fsync-critical shared
  markers both ranks journaled for the same ``(step_idx, epoch)``
  consensus round (verdicts and epoch advances happen within one KV
  poll of each other — good to ~0.1 s, which is what "skew larger
  than a hop" needs).
* :func:`to_trace` — export the merged timeline as Chrome/Perfetto
  ``trace_event`` JSON: one process ("track group") per rank, with
  hop / I/O / checkpoint / recovery / cluster tracks, and recovery
  epochs as global instant markers.  Load it at https://ui.perfetto.dev.
* :func:`render` — the ``pa-obs timeline`` text view: one line per
  ``(step_idx, epoch)`` group with each rank's activity side by side.

The joins all run on the correlation keys stamped since schema v2
(:mod:`~pencilarrays_tpu_torch.obs.correlate`): ``(step_idx, epoch)`` is the
group key, ``hop`` labels disambiguate within a group.
"""

from __future__ import annotations

import heapq
import json
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .straggler import _median

__all__ = [
    "MergedTimeline",
    "journal_files",
    "read_rank_journals",
    "estimate_offsets",
    "merge_journals",
    "to_trace",
    "write_trace",
    "render",
]

_JOURNAL_RE = re.compile(r"^journal\.r(\d+)(?:\.(\d+))?\.jsonl$")

# markers every rank journals for the SAME consensus round at nearly
# the same instant — the offset-estimation anchors
_MARKER_EVENTS = ("guard.epoch", "cluster.verdict")

# offsets below this are indistinguishable from KV poll jitter: applying
# them would only shuffle same-host records, so they are zeroed
_MIN_OFFSET_S = 0.5


@dataclass
class MergedTimeline:
    """The merged mesh view plus everything the merge had to tolerate."""

    directory: str
    events: List[dict] = field(default_factory=list)   # causally ordered
    ranks: List[int] = field(default_factory=list)     # journals found
    missing_ranks: List[int] = field(default_factory=list)
    offsets: Dict[int, float] = field(default_factory=dict)  # rank -> s
    offset_method: str = "none"
    warnings: List[str] = field(default_factory=list)

    def by_rank(self, rank: int) -> List[dict]:
        return [e for e in self.events if e.get("proc") == rank]

    def steps(self) -> List[Tuple[int, int]]:
        """``(step_idx, epoch)`` groups in first-appearance order."""
        seen, out = set(), []
        for e in self.events:
            key = (e.get("step_idx", 0), e.get("epoch", 0))
            if key not in seen:
                seen.add(key)
                out.append(key)
        return out


def journal_files(directory: str) -> Dict[int, List[str]]:
    """Per-rank journal segments in read order: rotated segments by
    ascending rotation index, the live (un-suffixed) file last — the
    append-order concatenation :func:`read_rank_journals` consumes."""
    by_rank: Dict[int, List[Tuple[float, str]]] = {}
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        return {}
    for name in names:
        m = _JOURNAL_RE.match(name)
        if not m:
            continue
        rank = int(m.group(1))
        # the live file sorts after every numbered segment
        order = int(m.group(2)) if m.group(2) else float("inf")
        by_rank.setdefault(rank, []).append(
            (order, os.path.join(directory, name)))
    return {r: [p for _, p in sorted(files)]
            for r, files in sorted(by_rank.items())}


def read_rank_journals(directory: str
                       ) -> Tuple[Dict[int, List[dict]], List[str]]:
    """Parse every rank's segments in append order.  Wreckage degrades
    to warnings: a torn/unparseable line is counted and skipped, an
    empty journal is reported but the rank stays in the result (an
    empty list — never silently dropped), an unreadable file is
    reported."""
    warnings: List[str] = []
    by_rank: Dict[int, List[dict]] = {}
    files = journal_files(directory)
    if not files:
        warnings.append(f"no journal files under {directory!r}")
        return {}, warnings
    for rank, paths in files.items():
        events: List[dict] = []
        for path in paths:
            try:
                with open(path) as f:
                    lines = f.readlines()
            except OSError as e:
                warnings.append(f"rank {rank}: unreadable segment "
                                f"{os.path.basename(path)}: {e}")
                continue
            torn_mid, torn_final = 0, False
            for i, line in enumerate(lines):
                line = line.strip()
                if not line:
                    continue
                try:
                    e = json.loads(line)
                except json.JSONDecodeError:
                    if i == len(lines) - 1:
                        torn_final = True
                    else:
                        torn_mid += 1
                    continue
                if isinstance(e, dict):
                    events.append(e)
            if torn_final:
                warnings.append(
                    f"rank {rank}: torn final line in "
                    f"{os.path.basename(path)} (crash mid-append — one "
                    f"record lost, the rest recovered)")
            if torn_mid:
                warnings.append(
                    f"rank {rank}: {torn_mid} unparseable mid-file "
                    f"line(s) in {os.path.basename(path)}")
        if not events:
            warnings.append(f"rank {rank}: journal is empty (rank kept "
                            f"in the timeline with no events)")
        by_rank[rank] = events
    # a hole in the rank sequence usually means a rank never got its
    # journal onto shared storage — exactly what a post-mortem must see
    present = sorted(by_rank)
    for r in range(present[-1] + 1 if present else 0):
        if r not in by_rank:
            warnings.append(f"rank {r}: no journal found (ranks present: "
                            f"{present})")
    return by_rank, warnings


def _sync_offsets(by_rank: Dict[int, List[dict]]
                  ) -> Dict[int, Tuple[float, float]]:
    """``(offset, error_bound)`` per rank from ``clock.sync`` records
    (the KV beacon exchange): each rank journaled its own measured
    offset against the reference rank, with the freshness bound of the
    sample it came from."""
    offsets: Dict[int, Tuple[float, float]] = {}
    for rank, events in by_rank.items():
        syncs = [e for e in events if e.get("ev") == "clock.sync"
                 and isinstance(e.get("offset_s"), (int, float))]
        if syncs:
            last = syncs[-1]
            bound = last.get("bound_s")
            offsets[rank] = (float(last["offset_s"]),
                             float(bound) if isinstance(
                                 bound, (int, float)) else 0.0)
    return offsets


def estimate_offsets(by_rank: Dict[int, List[dict]],
                     ref: Optional[int] = None
                     ) -> Tuple[Dict[int, float], List[str], str]:
    """Per-rank wall-clock offsets relative to ``ref`` (default: the
    lowest rank with events).  ``clock.sync`` records win; absent
    those, shared consensus markers are matched by
    ``(ev, step_idx, epoch, occurrence)`` and the median wall-time
    difference is the estimate — robust to one odd marker, and immune
    to the (corrected-away) case of skew far larger than a hop."""
    warnings: List[str] = []
    ranks_with = [r for r, evs in sorted(by_rank.items()) if evs]
    if not ranks_with:
        return {r: 0.0 for r in by_rank}, warnings, "none"
    if ref is None or ref not in ranks_with:
        ref = ranks_with[0]
    offsets = {r: 0.0 for r in by_rank}
    synced = _sync_offsets(by_rank)
    # the KV beacon's reference rank journals no clock.sync of its own:
    # the exchange is complete when every OTHER rank has one
    if len(ranks_with) > 1 and all(
            r in synced for r in ranks_with if r != ref):
        ref_off = synced.get(ref, (0.0, 0.0))[0]
        for r, (off, bound) in synced.items():
            rel = off - ref_off
            # an offset smaller than its own measurement bound (or the
            # global floor) is indistinguishable from exchange noise:
            # "correcting" an NTP-synced mesh by boot stagger would be
            # worse than leaving the clocks alone
            if abs(rel) > max(bound, _MIN_OFFSET_S):
                offsets[r] = rel
                warnings.append(
                    f"rank {r}: wall clock {rel:+.2f}s vs rank {ref} "
                    f"(KV clock exchange, bound ±{bound:.2f}s; "
                    f"corrected)")
        return offsets, warnings, "clock.sync"

    def markers(events: List[dict]) -> Dict[tuple, float]:
        seen: Dict[tuple, int] = {}
        out: Dict[tuple, float] = {}
        for e in events:
            if e.get("ev") not in _MARKER_EVENTS:
                continue
            base = (e["ev"], e.get("step_idx", 0), e.get("epoch", 0),
                    e.get("label") or e.get("reason"))
            n = seen.get(base, 0)
            seen[base] = n + 1
            out[base + (n,)] = float(e.get("t_wall", 0.0))
        return out

    ref_marks = markers(by_rank[ref])
    method = "none"
    for r in ranks_with:
        if r == ref:
            continue
        marks = markers(by_rank[r])
        diffs = [marks[k] - ref_marks[k] for k in marks if k in ref_marks]
        if not diffs:
            if len(by_rank[r]) and ref_marks:
                warnings.append(
                    f"rank {r}: no shared consensus markers with rank "
                    f"{ref} — clock skew not correctable (offset 0)")
            continue
        off = _median(diffs)
        method = "markers"
        if abs(off) >= _MIN_OFFSET_S:
            offsets[r] = off
            warnings.append(
                f"rank {r}: wall clock ~{off:+.2f}s vs rank {ref} "
                f"(estimated from {len(diffs)} shared marker(s); "
                f"corrected)")
    return offsets, warnings, method


def merge_journals(directory: str, *, correct_skew: bool = True,
                   ref: Optional[int] = None) -> MergedTimeline:
    """Build the mesh timeline for a journal directory.  Each event is
    annotated with ``t_corr`` — its skew-corrected wall time on the
    reference rank's clock — and the merge preserves every rank's own
    append order exactly (a k-way merge feeds each rank sequentially),
    so imperfect offsets can interleave ranks oddly but can never
    reorder one rank's records."""
    by_rank, warnings = read_rank_journals(directory)
    tl = MergedTimeline(directory=directory)
    tl.warnings = warnings
    tl.ranks = sorted(by_rank)
    tl.missing_ranks = sorted(
        set(range(tl.ranks[-1] + 1 if tl.ranks else 0)) - set(tl.ranks))
    if correct_skew:
        offsets, off_warnings, method = estimate_offsets(by_rank, ref)
        tl.warnings.extend(off_warnings)
    else:
        offsets, method = {r: 0.0 for r in by_rank}, "none"
    tl.offsets = offsets
    tl.offset_method = method
    streams = []
    for r, events in by_rank.items():
        off = offsets.get(r, 0.0)
        for e in events:
            e["t_corr"] = float(e.get("t_wall", 0.0)) - off
        streams.append(events)
    # k-way merge on corrected time; ties broken by (rank, position) so
    # the result is deterministic and per-rank order is preserved
    heap = []
    for si, stream in enumerate(streams):
        if stream:
            heapq.heappush(heap, (stream[0]["t_corr"], si, 0))
    merged: List[dict] = []
    while heap:
        _, si, i = heapq.heappop(heap)
        merged.append(streams[si][i])
        if i + 1 < len(streams[si]):
            heapq.heappush(heap, (streams[si][i + 1]["t_corr"], si, i + 1))
    tl.events = merged
    return tl


# ---------------------------------------------------------------------------
# Chrome/Perfetto trace_event export
# ---------------------------------------------------------------------------

# per-rank tracks (Perfetto "threads"): stable ids + display order
_TRACKS = {"run": 0, "hops": 1, "io": 2, "ckpt": 3, "recovery": 4,
           "cluster": 5, "serve": 6, "fleet": 7}

# dispatches that carry a priority lane (schema v5) render on dynamic
# per-lane tracks BELOW the serve and fleet tracks, so cross-lane
# overlap — a whale batch in flight while a minnow batch issues — is
# visible as two concurrent spans instead of interleaved instants on
# one line
_LANE_TRACK_BASE = 8

_TRACK_OF = {
    "hop": "hops",
    "io.open": "io", "io.write": "io", "io.read": "io",
    "ckpt.save": "ckpt", "ckpt.commit": "ckpt", "ckpt.restore": "ckpt",
    "ckpt.verify": "ckpt", "ckpt.gc": "ckpt",
    "guard.sdc": "recovery", "guard.hang": "recovery",
    "guard.recover": "recovery", "guard.bundle": "recovery",
    "retry": "recovery", "fault": "recovery",
    "cluster.verdict": "cluster", "cluster.lease": "cluster",
    "cluster.straggler": "cluster", "clock.sync": "cluster",
    "obs.agg": "cluster",
    "cluster.reform": "cluster", "cluster.member": "cluster",
    "cluster.quorum": "cluster", "cluster.fence": "cluster",
    "serve.request": "serve", "serve.coalesce": "serve",
    "serve.dispatch": "serve", "serve.complete": "serve",
    "serve.slo_violation": "serve", "serve.pressure": "serve",
    "serve.scale": "serve",
    "fleet.route": "fleet", "fleet.lease": "fleet",
    "fleet.failover": "fleet", "fleet.scale": "fleet",
    "fleet.wal": "fleet",
}

# events exported as complete ("X") spans: payload field holding the
# duration in seconds; the journal records each at its END time
_SPAN_DURATION_FIELD = {
    "hop": "dispatch_s",
    "io.write": "seconds",
    "io.read": "seconds",
    "ckpt.restore": "seconds",
    # a serve.complete records the request's full submit->done latency
    "serve.complete": "seconds",
}


def _span_name(e: dict) -> str:
    ev = e.get("ev", "?")
    if ev == "hop":
        return f"hop {e.get('method', '?')}"
    if ev == "plan.build":
        # the batched-throughput fields (schema v3): batch + the
        # slab/pencil decomposition verdict, when the plan carries them
        name = "plan"
        extra = e.get("extra_dims") or []
        if extra:
            name += f" batch={'x'.join(str(i) for i in extra)}"
        d = e.get("decomposition")
        if isinstance(d, dict) and d.get("mode", "fixed") != "fixed":
            name += (f" decomp={d.get('mode')}:"
                     f"{d.get('family', '?')}"
                     f"{tuple(d.get('winner', ()))}")
        return name
    if ev in ("io.write", "io.read"):
        return f"{ev} {e.get('dataset', '?')}"
    if ev == "ckpt.restore":
        return f"ckpt.restore step {e.get('step', '?')}"
    if ev == "ckpt.save":
        return f"ckpt.save step {e.get('step', '?')} {e.get('status', '')}"
    if ev == "guard.recover":
        return f"recover:{e.get('stage', '?')}"
    if ev == "fault":
        return f"fault {e.get('point', '?')}:{e.get('mode', '?')}"
    if ev == "cluster.verdict":
        return f"verdict {e.get('action', '?')}"
    if ev == "guard.epoch":
        return f"epoch {e.get('epoch', '?')}"
    if ev == "cluster.straggler":
        return f"straggler r{e.get('rank', '?')}"
    if ev == "cluster.reform":
        return f"reform g{e.get('gen', '?')}:{e.get('stage', '?')}"
    if ev == "cluster.member":
        return f"member r{e.get('rank', '?')}:{e.get('change', '?')}"
    if ev == "cluster.quorum":
        # the split-brain gate's verdict: a pass is routine, a fail is
        # THE minority-side story, a bypass is an operator override —
        # all three name the arithmetic (have/need of the denominator)
        verdict = str(e.get("verdict", "?")).upper()
        have = e.get("have")
        n_have = len(have) if isinstance(have, (list, tuple)) else "?"
        of = e.get("of")
        n_of = len(of) if isinstance(of, (list, tuple)) else "?"
        return (f"QUORUM-{verdict} g{e.get('gen', '?')} "
                f"{n_have}/{e.get('need', '?')} of {n_of}")
    if ev == "cluster.fence":
        # a rejected zombie write: the fence that stopped it, vs the
        # stale token the writer carried
        return (f"FENCED g{e.get('gen', '?')}e{e.get('epoch', '?')} "
                f"(fence g{e.get('fence_gen', '?')}"
                f"e{e.get('fence_epoch', '?')}) {e.get('key', '?')}")
    if ev == "serve.request":
        return f"serve.req {e.get('tenant', '?')}#{e.get('req', '?')}"
    if ev == "serve.coalesce":
        return f"coalesce n={e.get('n', '?')} ({e.get('reason', '?')})"
    if ev == "serve.dispatch":
        name = f"serve.dispatch n={e.get('n', '?')}"
        if isinstance(e.get("lane"), int):
            name += f" lane={e['lane']}"
        chain = e.get("chain")
        if chain and chain != "*":
            name += f" [{chain}]"
        return name
    if ev == "serve.complete":
        return (f"serve {e.get('tenant', '?')}#{e.get('req', '?')}:"
                f"{e.get('outcome', '?')}")
    if ev == "serve.slo_violation":
        late = e.get("late_s")
        suffix = (f" late={late:.3f}s"
                  if isinstance(late, (int, float)) else "")
        return (f"SLO-VIOLATION {e.get('tenant', '?')}"
                f"#{e.get('req', '?')}{suffix}")
    if ev == "serve.pressure":
        d = e.get("drain_s")
        drain = f" drain={d:.3f}s" if isinstance(d, (int, float)) else ""
        return (f"pressure {e.get('prev', '?')}->"
                f"{e.get('state', '?')}{drain}")
    if ev == "serve.scale":
        # the autoscaler's verdict, with whether capacity actually
        # moved — the projection inputs ride the record's args
        acted = "" if e.get("acted") else " (signal)"
        det = e.get("detail")
        return (f"scale {e.get('direction', '?')} "
                f"[{e.get('reason', '?')}]"
                f"{f' {det}' if det else ''}{acted}")
    if ev == "fleet.route":
        sb = e.get("score_bytes")
        score = (f" {sb / 1e6:.2f}MBe"
                 if isinstance(sb, (int, float)) else "")
        return (f"route {e.get('tenant', '?')}#{e.get('ticket', '?')}"
                f"->m{e.get('mesh', '?')} [{e.get('reason', '?')}]"
                f"{score}")
    if ev == "fleet.lease":
        age = e.get("age_s")
        suffix = (f" age={age:.2f}s"
                  if isinstance(age, (int, float)) else "")
        return f"mesh-lease m{e.get('mesh', '?')}:{e.get('status', '?')}" \
               + suffix
    if ev == "fleet.failover":
        d = e.get("detect_s")
        det = f" detect={d:.2f}s" if isinstance(d, (int, float)) else ""
        return (f"FAILOVER m{e.get('mesh', '?')} "
                f"tickets={e.get('tickets', '?')}{det}")
    if ev == "fleet.scale":
        acted = "" if e.get("acted") else " (signal)"
        mesh = e.get("mesh")
        return (f"fleet-scale {e.get('action', '?')} "
                f"[{e.get('reason', '?')}]"
                f"{f' m{mesh}' if mesh is not None else ''}{acted}")
    if ev == "fleet.wal":
        return (f"WAL-REPLAY [{e.get('outcome', '?')}] "
                f"replayed={e.get('replayed', '?')} "
                f"reparked={e.get('reparked', '?')} "
                f"resolved={e.get('resolved', '?')}")
    return ev


def to_trace(tl: MergedTimeline) -> dict:
    """Convert a merged timeline into Chrome ``trace_event`` JSON
    (Perfetto-loadable).  One "process" per rank, tracks per event
    family; hops / I/O / restores are complete spans (their records
    carry durations), everything else is an instant; recovery-epoch
    advances are *global* instant markers (drawn across every track) —
    the cross-rank alignment line.  Every event's args carry the full
    journal record, correlation keys included, so the join key is one
    click away in the UI."""
    if not tl.events:
        return {"traceEvents": [], "displayTimeUnit": "ms",
                "otherData": {"directory": tl.directory,
                              "warnings": tl.warnings}}
    t0 = min(e["t_corr"] for e in tl.events)
    lanes = sorted({e["lane"] for e in tl.events
                    if e.get("ev") == "serve.dispatch"
                    and isinstance(e.get("lane"), int)
                    and e["lane"] >= 0})
    out: List[dict] = []
    for rank in tl.ranks:
        out.append({"ph": "M", "name": "process_name", "pid": rank,
                    "args": {"name": f"rank {rank}"}})
        out.append({"ph": "M", "name": "process_sort_index", "pid": rank,
                    "args": {"sort_index": rank}})
        for track, tid in _TRACKS.items():
            out.append({"ph": "M", "name": "thread_name", "pid": rank,
                        "tid": tid, "args": {"name": track}})
            out.append({"ph": "M", "name": "thread_sort_index",
                        "pid": rank, "tid": tid,
                        "args": {"sort_index": tid}})
        for lane in lanes:
            tid = _LANE_TRACK_BASE + lane
            out.append({"ph": "M", "name": "thread_name", "pid": rank,
                        "tid": tid,
                        "args": {"name": f"serve.lane{lane}"}})
            out.append({"ph": "M", "name": "thread_sort_index",
                        "pid": rank, "tid": tid,
                        "args": {"sort_index": tid}})
    for e in tl.events:
        rank = int(e.get("proc", 0))
        ev = e.get("ev", "?")
        tid = _TRACKS[_TRACK_OF.get(ev, "run")]
        if (ev == "serve.dispatch" and isinstance(e.get("lane"), int)
                and e["lane"] >= 0):
            tid = _LANE_TRACK_BASE + e["lane"]
        ts_end = (e["t_corr"] - t0) * 1e6
        args = {k: v for k, v in e.items() if k != "t_corr"}
        dur_field = _SPAN_DURATION_FIELD.get(ev)
        dur_s = e.get(dur_field) if dur_field else None
        if isinstance(dur_s, (int, float)) and dur_s >= 0:
            out.append({"ph": "X", "name": _span_name(e), "pid": rank,
                        "tid": tid, "ts": ts_end - dur_s * 1e6,
                        "dur": max(dur_s * 1e6, 1.0), "args": args})
        else:
            rec = {"ph": "i", "name": _span_name(e), "pid": rank,
                   "tid": tid, "ts": ts_end, "s": "t", "args": args}
            if ev == "guard.epoch":
                rec["s"] = "g"   # the shared cross-rank marker
            elif ev == "cluster.reform" and e.get("stage") in (
                    "membership", "complete"):
                # reformation boundaries are mesh-wide alignment lines,
                # exactly like epoch advances (which they also cause)
                rec["s"] = "g"
            elif (ev == "cluster.quorum"
                  and e.get("verdict") in ("fail", "bypass")):
                # a quorum loss (or its operator override) is the
                # partition boundary itself — the mesh-wide line every
                # other rank's story hangs off
                rec["s"] = "g"
            out.append(rec)
    return {"traceEvents": out, "displayTimeUnit": "ms",
            "otherData": {
                "directory": tl.directory,
                "ranks": tl.ranks,
                "missing_ranks": tl.missing_ranks,
                "clock_offsets_s": {str(r): o
                                    for r, o in tl.offsets.items()},
                "offset_method": tl.offset_method,
                "warnings": tl.warnings,
            }}


def write_trace(directory: str, out_path: str, **merge_kwargs) -> dict:
    """``merge_journals`` + :func:`to_trace` + atomic publish."""
    from ..resilience.fsutil import atomic_write_text

    tl = merge_journals(directory, **merge_kwargs)
    trace = to_trace(tl)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    atomic_write_text(out_path, json.dumps(trace, separators=(",", ":")))
    return trace


# ---------------------------------------------------------------------------
# text rendering (the `pa-obs timeline` view)
# ---------------------------------------------------------------------------

_QUIET_EVENTS = frozenset({"run.start", "run.stop", "drift.sample",
                           "clock.sync", "obs.agg"})


def render(tl: MergedTimeline, *, max_groups: int = 200) -> str:
    """Human-readable step timeline: one line per ``(step_idx, epoch)``
    group, each rank's activity summarized side by side, anomalies
    (faults, SDC, hangs, verdicts, stragglers) spelled out."""
    lines = [f"timeline: {tl.directory}",
             f"ranks: {tl.ranks or 'none'}"
             + (f"  MISSING: {tl.missing_ranks}" if tl.missing_ranks
                else "")]
    if any(tl.offsets.values()):
        lines.append("clock offsets vs ref (s): "
                     + ", ".join(f"r{r}={o:+.3f}"
                                 for r, o in sorted(tl.offsets.items())
                                 if o) + f"  [{tl.offset_method}]")
    for w in tl.warnings:
        lines.append(f"WARNING: {w}")
    groups = tl.steps()
    if len(groups) > max_groups:
        lines.append(f"({len(groups) - max_groups} step groups elided; "
                     f"showing the last {max_groups})")
        groups = groups[-max_groups:]
    shown = set(groups)
    by_group: Dict[tuple, Dict[int, List[dict]]] = {}
    for e in tl.events:
        key = (e.get("step_idx", 0), e.get("epoch", 0))
        if key in shown:
            by_group.setdefault(key, {}).setdefault(
                int(e.get("proc", 0)), []).append(e)
    for key in groups:
        step_idx, epoch = key
        parts = []
        for rank in sorted(by_group.get(key, {})):
            evs = by_group[key][rank]
            counts: Dict[str, int] = {}
            loud: List[str] = []
            for e in evs:
                ev = e.get("ev", "?")
                if ev in _QUIET_EVENTS:
                    continue
                if ev in ("fault", "guard.sdc", "guard.hang",
                          "guard.recover", "cluster.verdict",
                          "cluster.straggler", "guard.epoch",
                          "guard.bundle", "retry",
                          "cluster.reform", "cluster.member",
                          # the overload plane's decisions gate
                          # client-visible behavior: spell them out
                          "serve.slo_violation", "serve.pressure",
                          "serve.scale",
                          # fleet health/failover/scaling decisions
                          # gate whole meshes: always spelled out
                          # (fleet.route is high-rate and counted)
                          "fleet.lease", "fleet.failover",
                          "fleet.scale",
                          # partition-tolerance verdicts (schema v8):
                          # quorum math, rejected zombie writes and
                          # WAL replays ARE the post-mortem — loud
                          "cluster.quorum", "cluster.fence",
                          "fleet.wal"):
                    loud.append(_span_name(e))
                elif (ev == "plan.build"
                      and isinstance(e.get("decomposition"), dict)
                      and e["decomposition"].get("mode",
                                                 "fixed") != "fixed"):
                    # an auto-decomposition verdict is a planning
                    # decision worth spelling out, like a route verdict
                    loud.append(_span_name(e))
                elif (ev == "serve.complete"
                      and e.get("outcome") != "ok"):
                    # a failed request is a client-visible anomaly —
                    # name the tenant and the typed outcome
                    loud.append(_span_name(e))
                else:
                    counts[ev] = counts.get(ev, 0) + 1
            summary = " ".join(f"{ev}×{n}" if n > 1 else ev
                               for ev, n in sorted(counts.items()))
            if loud:
                summary = (summary + " " if summary else "") + \
                    " ".join(loud)
            parts.append(f"r{rank}[{summary or 'idle'}]")
        lines.append(f"step {step_idx} epoch {epoch}: " + "  ".join(parts))
    return "\n".join(lines)
