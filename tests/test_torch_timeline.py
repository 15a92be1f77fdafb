"""PyTorch port vs JAX package: the mesh observability plane — the
timeline merger, journal rotation, correlation keys, straggler
detection, the mesh aggregator over ``FileKV``, the Prometheus exporter
and the ``pa-obs`` command line (the cases of ``tests/test_timeline.py``,
run on the port; cases the JAX package ran on its 8-device mesh run on a
one-rank topology or on gloo ranks).

Parity, with no tolerance (records, strings and exit codes): the port's
merge of the same hostile directories (torn lines, rotated segments,
missing ranks, clock skew, clock.sync records) equals the JAX package's,
event for event, with the same warnings, offsets and Chrome trace; a
journal the JAX package wrote merges and lints clean in the port and the
reverse; both command lines print the same output and exit the same way
on the same directory; a straggler delayed by ``%rank1`` on 4 gloo ranks
is flagged by both packages' offline rule.
"""

import json
import os

import pytest

import pencilarrays_tpu_torch as pa
import torch_rank_tasks as tasks
from pencilarrays_tpu import obs as jobs
from pencilarrays_tpu.obs import events as jax_events
from pencilarrays_tpu.obs import metrics as jax_metrics
from pencilarrays_tpu.obs import straggler as jax_straggler
from pencilarrays_tpu.obs import timeline as jax_timeline
from pencilarrays_tpu.obs.__main__ import main as jax_main
from pencilarrays_tpu_torch import obs
from pencilarrays_tpu_torch.cluster.kv import FileKV
from pencilarrays_tpu_torch.obs import aggregate as obs_agg
from pencilarrays_tpu_torch.obs import correlate as obs_correlate
from pencilarrays_tpu_torch.obs import drift as obs_drift
from pencilarrays_tpu_torch.obs import events as obs_events
from pencilarrays_tpu_torch.obs import metrics as obs_metrics
from pencilarrays_tpu_torch.obs import straggler as obs_straggler
from pencilarrays_tpu_torch.obs import timeline as obs_timeline
from pencilarrays_tpu_torch.obs.__main__ import main as pa_obs_main


@pytest.fixture(autouse=True)
def _clean_obs(monkeypatch):
    monkeypatch.delenv(obs.ENV_VAR, raising=False)
    monkeypatch.delenv("PENCILARRAYS_TPU_OBS_DIR", raising=False)
    monkeypatch.delenv("PENCILARRAYS_TPU_OBS_MAX_MB", raising=False)
    obs_events._reset_for_tests()
    jax_events._reset_for_tests()
    obs_metrics.registry.reset()
    jax_metrics.registry.reset()
    obs_drift.drift_tracker.reset()
    yield
    obs_events._reset_for_tests()
    jax_events._reset_for_tests()
    obs_metrics.registry.reset()
    jax_metrics.registry.reset()
    obs_drift.drift_tracker.reset()


def _rec(rank, seq, ev, t, step=1, epoch=0, **fields):
    """A synthetic v2 journal record with every required field."""
    rec = {"v": 2, "ev": ev, "run": f"run-r{rank}", "proc": rank,
           "seq": seq, "t_wall": t, "t_mono": t, "step_idx": step,
           "epoch": epoch}
    rec.update(fields)
    return rec


def _hop(rank, seq, t, step=1, epoch=0, dispatch_s=0.001, hop="H"):
    return _rec(rank, seq, "hop", t, step, epoch, method="AllToAll",
                hop=hop, r=0, chunks=1, predicted_bytes=1024,
                dispatch_s=dispatch_s)


def _write_journal(d, rank, events, segment=None):
    os.makedirs(d, exist_ok=True)
    name = (f"journal.r{rank}.jsonl" if segment is None
            else f"journal.r{rank}.{segment}.jsonl")
    with open(os.path.join(d, name), "a") as f:
        for e in events:
            f.write(json.dumps(e) + "\n")
    return os.path.join(d, name)


# ---------------------------------------------------------------------------
# hostile merge inputs
# ---------------------------------------------------------------------------


def test_merge_torn_final_line_warns_not_throws(tmp_path):
    d = str(tmp_path)
    _write_journal(d, 0, [_hop(0, 1, 10.0), _hop(0, 2, 11.0)])
    with open(os.path.join(d, "journal.r0.jsonl"), "a") as f:
        f.write('{"v":2,"ev":"hop","proc":0,"t_wa')   # SIGKILL mid-append
    tl = obs_timeline.merge_journals(d)
    assert len(tl.events) == 2
    assert any("torn final line" in w for w in tl.warnings), tl.warnings
    assert obs.lint_journal(tl.events) == []


def test_merge_interleaved_rotated_segments(tmp_path):
    """Rotated segments read in rotation order, live file last — the
    rank's append order is reconstructed even though lexicographic
    filename order would interleave them wrongly (k=10 < k=2)."""
    d = str(tmp_path)
    seq = 0
    for k in list(range(1, 11)):
        seq += 1
        _write_journal(d, 0, [_hop(0, seq, 10.0)], segment=k)
    # identical wall times everywhere: the merge order must come from
    # the segment order alone (lexicographic would read k=10 before k=2)
    _write_journal(d, 0, [_hop(0, seq + 1, 10.0)])
    tl = obs_timeline.merge_journals(d)
    seqs = [e["seq"] for e in tl.events]
    assert seqs == sorted(seqs) and len(seqs) == 11


def test_merge_missing_rank_is_loud(tmp_path):
    d = str(tmp_path)
    _write_journal(d, 0, [_hop(0, 1, 10.0)])
    _write_journal(d, 2, [_hop(2, 1, 10.0)])
    tl = obs_timeline.merge_journals(d)
    assert tl.ranks == [0, 2]
    assert tl.missing_ranks == [1]
    assert any("rank 1: no journal" in w for w in tl.warnings), tl.warnings


def test_merge_empty_journal_keeps_rank(tmp_path):
    d = str(tmp_path)
    _write_journal(d, 0, [_hop(0, 1, 10.0)])
    open(os.path.join(d, "journal.r1.jsonl"), "w").close()
    tl = obs_timeline.merge_journals(d)
    assert tl.ranks == [0, 1]          # never silently dropped
    assert any("rank 1" in w and "empty" in w for w in tl.warnings)


def test_merge_corrects_clock_skew_larger_than_a_hop(tmp_path):
    """Rank 1's wall clock is an hour ahead; the shared epoch markers
    re-align the ranks, so the merged order interleaves the two ranks'
    step-1 work instead of putting all of rank 0 first."""
    d = str(tmp_path)
    skew = 3600.0
    marker = dict(reason="verdict:retry")
    _write_journal(d, 0, [
        _hop(0, 1, 100.0),
        _rec(0, 2, "guard.epoch", 101.0, epoch=1, **marker),
        _hop(0, 3, 102.0, epoch=1),
    ])
    _write_journal(d, 1, [
        _hop(1, 1, 100.2 + skew),
        _rec(1, 2, "guard.epoch", 101.1 + skew, epoch=1, **marker),
        _hop(1, 3, 102.3 + skew, epoch=1),
    ])
    tl = obs_timeline.merge_journals(d)
    assert tl.offset_method == "markers"
    assert tl.offsets[1] == pytest.approx(skew, abs=1.0)
    assert any("clock" in w for w in tl.warnings), tl.warnings
    order = [(e["proc"], e["seq"]) for e in tl.events]
    assert order == [(0, 1), (1, 1), (0, 2), (1, 2), (0, 3), (1, 3)]
    # without correction the hour of skew puts rank 0 entirely first
    raw = obs_timeline.merge_journals(d, correct_skew=False)
    assert [(e["proc"]) for e in raw.events] == [0, 0, 0, 1, 1, 1]


def test_merge_prefers_kv_clock_sync_records(tmp_path):
    d = str(tmp_path)
    _write_journal(d, 0, [_hop(0, 1, 100.0)])
    _write_journal(d, 1, [
        _rec(1, 1, "clock.sync", 160.0, ref_rank=0, offset_s=60.0,
             method="kv"),
        _hop(1, 2, 160.5),
    ])
    tl = obs_timeline.merge_journals(d)
    assert tl.offset_method == "clock.sync"
    assert tl.offsets[1] == pytest.approx(60.0)
    # rank 1's hop lands at corrected t=100.5: after rank 0's t=100
    assert [(e["proc"], e["ev"]) for e in tl.events][-1] == (1, "hop")


def test_merge_empty_directory(tmp_path):
    tl = obs_timeline.merge_journals(str(tmp_path))
    assert tl.events == [] and tl.ranks == []
    assert any("no journal files" in w for w in tl.warnings)
    # the trace of nothing is still valid trace JSON
    trace = obs_timeline.to_trace(tl)
    assert trace["traceEvents"] == []


# ---------------------------------------------------------------------------
# journal rotation
# ---------------------------------------------------------------------------


def test_journal_rotation_caps_and_reads_transparently(tmp_path,
                                                       monkeypatch):
    jdir = str(tmp_path / "obs")
    monkeypatch.setenv(obs.ENV_VAR, jdir)
    monkeypatch.setenv(obs_events.MAX_MB_VAR, "0.001")   # ~1 KiB cap
    for i in range(40):
        obs.record_event("run.stop", note="x" * 120)
    files = sorted(os.listdir(jdir))
    rotated = [f for f in files if f.startswith("journal.r0.")
               and f != "journal.r0.jsonl"]
    assert rotated, files
    # every segment honors the cap plus at most one record of slack
    for f in files:
        if f.startswith("journal.r0"):
            assert os.path.getsize(os.path.join(jdir, f)) < 2048
    # both readers see every record, in order, exactly once
    events = obs.read_journal(jdir)
    stops = [e for e in events if e["ev"] == "run.stop"]
    assert len(stops) == 40
    tl = obs_timeline.merge_journals(jdir)
    seqs = [e["seq"] for e in tl.events]
    assert seqs == sorted(seqs) and len(set(seqs)) == len(seqs)
    assert obs.lint_journal(tl.events) == []
    # rotation happens at record boundaries: no torn-line warnings
    assert not any("torn" in w for w in tl.warnings), tl.warnings


def test_no_rotation_without_cap(tmp_path, monkeypatch):
    jdir = str(tmp_path / "obs")
    monkeypatch.setenv(obs.ENV_VAR, jdir)
    for _ in range(40):
        obs.record_event("run.stop", note="x" * 120)
    assert sorted(os.listdir(jdir)) == ["journal.r0.jsonl"]


# ---------------------------------------------------------------------------
# correlation keys
# ---------------------------------------------------------------------------


def test_guarded_step_advances_step_idx(tmp_path, monkeypatch):
    from pencilarrays_tpu_torch import guard

    monkeypatch.setenv(obs.ENV_VAR, str(tmp_path / "obs"))
    base = obs_correlate.current_step()
    obs.record_event("run.stop")
    guard.guarded_step(lambda: 1, label="s")
    obs.record_event("run.stop")
    guard.guarded_step(lambda: 2, label="s")
    obs.record_event("run.stop")
    stops = [e for e in obs.read_journal() if e["ev"] == "run.stop"]
    assert [e["step_idx"] - base for e in stops] == [0, 1, 2]
    assert all(e["epoch"] == 0 for e in stops)
    assert obs.lint_journal(obs.read_journal()) == []


def test_plan_fingerprint_stamped_on_hops(tmp_path, monkeypatch):
    """A one-rank plan makes no hop (the single-device schedule), so the
    hop runs after the plan's forward, under its correlation stamp."""
    monkeypatch.setenv(obs.ENV_VAR, str(tmp_path / "obs"))
    topo = pa.Topology((1, 1), device="cpu")
    plan = pa.PencilFFTPlan(topo, (16, 12, 10), real=True)
    u = plan.allocate_input()
    plan.forward(u)
    pa.transpose(u, u.pencil.replace(decomp_dims=(0, 2)))
    events = obs.read_journal()
    hops = [e for e in events if e["ev"] == "hop"]
    assert hops and all(e.get("plan_fp") == plan.plan_key()
                        for e in hops), hops
    build = next(e for e in events if e["ev"] == "plan.build")
    assert build["plan_fp"] == plan.plan_key()


def test_route_plan_fp_prefixes_bundle_sha(tmp_path, monkeypatch):
    """The journal's ``plan_fp`` must be a PREFIX of the crash bundle's
    ``schedule_sha256`` for routed reshards too (one summary dict feeds
    both digests) — that prefix match is how a post-mortem ties a
    record to the compiled chain that was in flight."""
    from pencilarrays_tpu_torch import guard
    from pencilarrays_tpu_torch.guard import bundle as gb
    from pencilarrays_tpu_torch.parallel.transpositions import Ring

    monkeypatch.setenv(obs.ENV_VAR, str(tmp_path / "obs"))
    guard._reset_for_tests()
    guard.enable(str(tmp_path / "bundles"))
    try:
        topo = pa.Topology((1, 1), device="cpu")
        pen_a = pa.Pencil(topo, (12, 16, 10), (0, 1))
        pen_b = pa.Pencil(topo, (12, 16, 10), (1, 2))
        pa.reshard(pa.PencilArray.zeros(pen_a), pen_b, method=Ring())
        fp = obs_correlate.current_plan()
        shas = [p["schedule_sha256"] for p in gb.recent_plans()
                if p["kind"] == "reshard_route"]
        assert fp and any(s.startswith(fp) for s in shas), (fp, shas)
        obs.record_event("run.stop")
        ev = [e for e in obs.read_journal() if e["ev"] == "run.stop"][-1]
        assert ev["plan_fp"] == fp
    finally:
        guard.disable()


def test_explicit_payload_epoch_wins_over_stamp(tmp_path, monkeypatch):
    """An emitter that journals its OWN epoch (a consensus verdict's
    agreed value) must not have it rewritten by the global counter at
    write time — the stamp only fills in missing keys."""
    monkeypatch.setenv(obs.ENV_VAR, str(tmp_path / "obs"))
    obs.record_event("cluster.verdict", label="x", action="ok", epoch=7)
    ev = [e for e in obs.read_journal()
          if e["ev"] == "cluster.verdict"][-1]
    assert ev["epoch"] == 7
    assert "step_idx" in ev   # the other keys still stamped
    assert obs.lint_journal(obs.read_journal()) == []


def test_schema_v2_requires_correlation_keys():
    v2 = _hop(0, 1, 1.0)
    assert obs.lint_event(v2) == []
    missing = dict(v2)
    del missing["step_idx"]
    assert any("correlation key 'step_idx'" in e
               for e in obs.lint_event(missing))
    # v1 records (pre-PR-7 journals) stay lint-clean without the keys
    v1 = dict(v2, v=1)
    del v1["step_idx"], v1["epoch"]
    assert obs.lint_event(v1) == []


# ---------------------------------------------------------------------------
# straggler detection
# ---------------------------------------------------------------------------


def test_straggler_two_rank_floor():
    flags = obs_straggler.detect({0: {"H": 0.002}, 1: {"H": 0.302}})
    assert len(flags) == 1
    f = flags[0]
    assert f["rank"] == 1 and f["excess_s"] == pytest.approx(0.3)
    # microsecond jitter never flags anyone (the absolute floor)
    assert obs_straggler.detect({0: {"H": 0.0020}, 1: {"H": 0.0021}}) == []


def test_straggler_robust_z_on_larger_world():
    durs = {r: {"H": 0.010 + 0.0001 * r} for r in range(7)}
    durs[3] = {"H": 0.500}
    flags = obs_straggler.detect(durs)
    assert [f["rank"] for f in flags] == [3]
    # an outlier below the z threshold but above the floor: peers'
    # spread is wide, so the same excess is NOT an anomaly
    spread = {0: {"H": 0.1}, 1: {"H": 0.4}, 2: {"H": 0.7},
              3: {"H": 1.0}, 4: {"H": 1.3}}
    assert obs_straggler.detect(spread) == []


def test_straggler_single_rank_hop_skipped():
    assert obs_straggler.detect({0: {"H": 9.0}}) == []
    assert obs_straggler.detect({0: {"A": 9.0}, 1: {"B": 0.1}}) == []


def test_straggler_from_events_matches_live_rule():
    events = [_hop(0, i, 10.0 + i, dispatch_s=0.001) for i in range(3)]
    events += [_hop(1, i, 10.0 + i, dispatch_s=0.35 + 0.01 * i)
               for i in range(3)]
    flags = obs_straggler.detect_from_events(events)
    assert len(flags) == 1 and flags[0]["rank"] == 1
    # min is the representative: one slow outlier dispatch on a healthy
    # rank (compile, GC) must not flag it
    events = [_hop(0, 1, 10.0, dispatch_s=0.9),
              _hop(0, 2, 11.0, dispatch_s=0.001),
              _hop(1, 1, 10.0, dispatch_s=0.001)]
    assert obs_straggler.detect_from_events(events) == []


def test_straggler_windowed_catches_late_onset_degradation():
    """A rank that warms up fast and THEN degrades (thermal throttling
    mid-job) keeps its old all-time minimum — only the windowed mean
    between fold ticks (Δtotal/Δcount) can flag it."""
    def snap(count, total, mn):
        return {"drift": {"hops": {"H": {
            "source": "dispatch", "count": count, "total_s": total,
            "measured_s": mn}}}}

    # 1000 fast dispatches (1 ms), then 100 at 0.5 s on rank 1 only
    prev = {0: snap(1000, 1.0, 0.001), 1: snap(1000, 1.0, 0.001)}
    now = {0: snap(1100, 1.1, 0.001), 1: snap(1100, 51.0, 0.001)}
    # the all-time-min path is blind to it...
    assert obs_straggler.scan_snapshots(now) == []
    # ...the windowed path is not
    flags = obs_straggler.scan_snapshots(now, prev=prev)
    assert [f["rank"] for f in flags] == [1]
    assert flags[0]["duration_s"] == pytest.approx(0.5)
    # a hop with no new dispatches in the window is stale, not flagged
    idle = {0: snap(1100, 1.1, 0.001), 1: snap(1000, 1.0, 0.001)}
    assert obs_straggler.scan_snapshots(idle, prev=prev) == []


def test_scan_snapshots_emits_once_with_dedup(tmp_path, monkeypatch):
    monkeypatch.setenv(obs.ENV_VAR, str(tmp_path / "obs"))
    snaps = {0: {"drift": {"hops": {"H": {"measured_s": 0.001}}}},
             1: {"drift": {"hops": {"H": {"measured_s": 0.401}}}}}
    seen = set()
    flags = obs_straggler.scan_snapshots(snaps, emit=True, seen=seen)
    assert len(flags) == 1
    flags = obs_straggler.scan_snapshots(snaps, emit=True, seen=seen)
    assert len(flags) == 1   # still detected, but journaled only once
    events = [e for e in obs.read_journal()
              if e["ev"] == "cluster.straggler"]
    assert len(events) == 1
    assert events[0]["rank"] == 1
    assert events[0]["excess_s"] == pytest.approx(0.4)
    snap = obs.snapshot()
    assert snap["counters"]["cluster.stragglers{rank=1}"] == 1
    assert obs.lint_journal(obs.read_journal()) == []


# ---------------------------------------------------------------------------
# mesh aggregation
# ---------------------------------------------------------------------------


def _snap_with(counters=None, gauges=None, histograms=None, series=None):
    return {"counters": counters or {}, "gauges": gauges or {},
            "histograms": histograms or {}, "series": series or [],
            "drift": {"hops": {}}}


def test_fold_snapshots_merge_semantics():
    h0 = {"count": 2, "total": 1.0, "min": 0.4, "max": 0.6,
          "buckets_le_pow2": {"0": 2}}
    h1 = {"count": 3, "total": 6.0, "min": 0.1, "max": 4.0,
          "buckets_le_pow2": {"0": 1, "3": 2}}
    fold = obs_agg.fold_snapshots({
        0: _snap_with(counters={"c": 2}, gauges={"g": 1.0},
                      histograms={"h": h0}),
        2: _snap_with(counters={"c": 3}, gauges={"g": 5.0},
                      histograms={"h": h1}),
    })
    assert fold["ranks"] == [0, 2] and fold["missing_ranks"] == [1]
    assert fold["counters"]["c"] == 5
    assert fold["gauges"]["g"] == {"r0": 1.0, "r2": 5.0}
    h = fold["histograms"]["h"]
    assert h["count"] == 5 and h["total"] == pytest.approx(7.0)
    assert h["min"] == 0.1 and h["max"] == 4.0
    assert h["buckets_le_pow2"] == {"0": 3, "3": 2}
    assert h["mean"] == pytest.approx(1.4)


def test_mesh_prometheus_rank_labels_and_escaping():
    snaps = {
        0: _snap_with(series=[
            {"kind": "counter", "name": "c.x",
             "labels": {"fp": 'a"b\nc'}, "value": 2}]),
        1: _snap_with(series=[
            {"kind": "counter", "name": "c.x", "labels": {}, "value": 3},
            {"kind": "gauge", "name": "g", "labels": {}, "value": 7.5},
            {"kind": "histogram", "name": "h", "labels": {},
             "count": 4, "total": 2.0}]),
    }
    text = obs_agg.mesh_prometheus(snaps)
    assert 'pa_c_x_total{fp="a\\"b\\nc",rank="0"} 2' in text
    assert 'pa_c_x_total{rank="1"} 3' in text
    assert 'pa_g{rank="1"} 7.5' in text
    assert 'pa_h_count{rank="1"} 4' in text
    # label collision: a series-own `rank` label (the straggler's) must
    # survive the publisher label as exported_rank, not be clobbered
    collide = obs_agg.mesh_prometheus({0: _snap_with(series=[
        {"kind": "counter", "name": "cluster.stragglers",
         "labels": {"rank": "1"}, "value": 1}])})
    assert ('pa_cluster_stragglers_total'
            '{exported_rank="1",rank="0"} 1') in collide
    for line in text.splitlines():
        assert "\n" not in line   # no raw newline ever leaks into a value


def test_mesh_aggregator_publish_fold_over_filekv(tmp_path, monkeypatch):
    monkeypatch.setenv(obs.ENV_VAR, str(tmp_path / "obs"))
    kv = FileKV(str(tmp_path / "kv"))
    a0 = obs_agg.MeshAggregator(kv, 0, 2, cadence=60)
    a1 = obs_agg.MeshAggregator(kv, 1, 2, cadence=60)
    obs.counter("fold.me").inc(4)
    assert a0.publish_once() and a1.publish_once()
    fold = a0.fold_once(wait=True, timeout=5)
    assert fold is not None and fold["missing_ranks"] == []
    # both ranks published THIS process's registry: the fold sums them
    assert fold["counters"]["fold.me"] == 8
    jdir = str(tmp_path / "obs")
    assert os.path.exists(os.path.join(jdir, "mesh_metrics.json"))
    with open(os.path.join(jdir, "mesh_metrics.prom")) as f:
        prom = f.read()
    assert 'pa_fold_me_total{rank="0"} 4' in prom
    assert 'pa_fold_me_total{rank="1"} 4' in prom
    # non-rank-0 never folds
    assert a1.fold_once() is None
    # fold with a missing rank: a gap, not an exception
    kv.delete("pa/obsagg/r1")
    fold = a0.fold_once()
    assert fold["missing_ranks"] == [1]
    assert obs.lint_journal(obs.read_journal()) == []


def test_clock_beacon_offset_estimate(tmp_path, monkeypatch):
    monkeypatch.setenv(obs.ENV_VAR, str(tmp_path / "obs"))
    kv = FileKV(str(tmp_path / "kv"))
    a0 = obs_agg.MeshAggregator(kv, 0, 2, cadence=60)
    a1 = obs_agg.MeshAggregator(kv, 1, 2, cadence=60)
    assert a0.sync_clock_once() == 0.0
    # a first sighting has unknown staleness: NO sample — a stale
    # beacon read measures boot stagger, not skew (the review finding)
    assert a1.sync_clock_once() is None
    assert a0.sync_clock_once() == 0.0       # beacon refreshed
    off = a1.sync_clock_once()               # changed + recent: valid
    assert off is not None and 0.0 <= off < 1.0   # same host: ~delivery
    syncs = [e for e in obs.read_journal() if e["ev"] == "clock.sync"]
    assert len(syncs) == 1 and syncs[0]["ref_rank"] == 0
    assert syncs[0]["method"] == "kv"
    assert 0.0 <= syncs[0]["bound_s"] < 1.0


def test_merge_ignores_clock_sync_below_its_bound(tmp_path):
    """An exchanged offset smaller than its own measurement bound is
    exchange noise: 'correcting' an NTP-synced mesh by boot stagger
    would be worse than leaving the clocks alone."""
    d = str(tmp_path)
    _write_journal(d, 0, [_hop(0, 1, 100.0)])
    _write_journal(d, 1, [
        _rec(1, 1, "clock.sync", 100.3, ref_rank=0, offset_s=0.3,
             bound_s=0.4, method="kv"),
        _hop(1, 2, 100.4),
    ])
    tl = obs_timeline.merge_journals(d)
    assert tl.offset_method == "clock.sync"
    assert tl.offsets[1] == 0.0   # below its ±0.4 s bound: not applied


def test_clock_beacon_stale_read_never_samples(tmp_path, monkeypatch):
    """A beacon read after a long gap (boot stagger, coarse cadence)
    must not produce an offset: the staleness is unbounded."""
    monkeypatch.setenv(obs.ENV_VAR, str(tmp_path / "obs"))
    kv = FileKV(str(tmp_path / "kv"))
    a0 = obs_agg.MeshAggregator(kv, 0, 2, cadence=60)
    a1 = obs_agg.MeshAggregator(kv, 1, 2, cadence=60)
    a0.sync_clock_once()
    assert a1.sync_clock_once() is None
    a0.sync_clock_once()
    a1._last_beacon_read -= 10.0      # simulate a 10 s read gap
    assert a1.sync_clock_once() is None
    assert [e for e in obs.read_journal()
            if e["ev"] == "clock.sync"] == []


# ---------------------------------------------------------------------------
# prometheus exporter fixes (per-process registry)
# ---------------------------------------------------------------------------


def test_prometheus_escapes_hostile_label_values():
    obs.counter("evil.count", fp='say "hi"\nEOF').inc()
    text = obs.to_prometheus()
    line = next(l for l in text.splitlines() if "evil" in l and "#" not in l)
    assert line == 'pa_evil_count_total{fp="say \\"hi\\"\\nEOF"} 1'
    # the exposition grammar holds: every sample line still parses
    for l in text.splitlines():
        if l and not l.startswith("#"):
            assert " " in l and l.rsplit(" ", 1)[1]


def test_prometheus_emits_cluster_counters_and_drift_gauges():
    obs.counter("cluster.verdicts", action="retry").inc()
    obs.counter("cluster.stragglers", rank="1").inc()
    obs.gauge("cluster.epoch").set(2)
    obs_drift.drift_tracker.record("hopA", 100, 1.0, source="benchtime")
    obs_drift.drift_tracker.record("hopB", 300, 3.0, source="benchtime")
    text = obs.to_prometheus()
    assert 'pa_cluster_verdicts_total{action="retry"} 1' in text
    assert 'pa_cluster_stragglers_total{rank="1"} 1' in text
    assert "pa_cluster_epoch 2" in text
    assert 'pa_drift{hop="hopA",source="benchtime"} 1' in text
    assert 'pa_drift_fitted_bytes_per_s{class="device"} 100' in text


def test_snapshot_series_mirror_is_structured():
    obs.counter("s.c", method="Pipelined(chunks=2, base=AllToAll())").inc()
    snap = obs.snapshot()
    (s,) = [x for x in snap["series"] if x["name"] == "s.c"]
    assert s["kind"] == "counter" and s["value"] == 1
    # the label VALUE contains ',' and '=' — structurally intact here,
    # which is why the mesh fold never re-parses display keys
    assert s["labels"] == {
        "method": "Pipelined(chunks=2, base=AllToAll())"}


# ---------------------------------------------------------------------------
# pa-obs CLI
# ---------------------------------------------------------------------------


def test_cli_merge_lint_trace_roundtrip(tmp_path, capsys):
    d = str(tmp_path / "j")
    _write_journal(d, 0, [_hop(0, 1, 10.0),
                          _rec(0, 2, "guard.epoch", 11.0, epoch=1,
                               reason="verdict:retry")])
    _write_journal(d, 1, [_hop(1, 1, 10.1),
                          _rec(1, 2, "guard.epoch", 11.1, epoch=1,
                               reason="verdict:retry")])
    out = str(tmp_path / "merged.jsonl")
    assert pa_obs_main(["merge", d, "-o", out]) == 0
    with open(out) as f:
        merged = [json.loads(l) for l in f]
    assert len(merged) == 4
    assert pa_obs_main(["lint", d]) == 0
    capsys.readouterr()
    assert pa_obs_main(["timeline", d]) == 0
    text = capsys.readouterr().out
    assert "step 1 epoch 0" in text and "step 1 epoch 1" in text
    tr = str(tmp_path / "trace.json")
    assert pa_obs_main(["trace", d, "-o", tr]) == 0
    with open(tr) as f:
        trace = json.load(f)
    assert {e["pid"] for e in trace["traceEvents"]} == {0, 1}
    names = {e["name"] for e in trace["traceEvents"]}
    assert "hop AllToAll" in names and "epoch 1" in names


def test_cli_lint_fails_on_schema_errors(tmp_path, capsys):
    d = str(tmp_path / "j")
    bad = _hop(0, 1, 10.0)
    del bad["method"]   # required hop field
    _write_journal(d, 0, [bad])
    assert pa_obs_main(["lint", d]) == 1
    assert "missing required field" in capsys.readouterr().out


def test_cli_drift_and_bundle(tmp_path, capsys, monkeypatch):
    d = str(tmp_path / "obs")
    monkeypatch.setenv(obs.ENV_VAR, d)
    obs_drift.drift_tracker.record("hopA", 100, 1.0, source="benchtime")
    obs.write_snapshot()
    assert pa_obs_main(["drift", d]) == 0
    out = capsys.readouterr().out
    assert "hopA" in out and "benchtime" in out
    # bundle summary + the merged-timeline pointer in the manifest
    from pencilarrays_tpu_torch import guard
    from pencilarrays_tpu_torch.guard.bundle import write_crash_bundle

    guard._reset_for_tests()   # earlier tests may have spent the cap
    guard.enable(str(tmp_path / "bundles"))
    try:
        obs.record_event("run.stop")
        path = write_crash_bundle("unit-test", "cli", error="boom")
        assert path is not None
        with open(os.path.join(path, "MANIFEST.json")) as f:
            man = json.load(f)
        assert man["timeline_cmd"].endswith(os.path.join(path, "journal"))
        assert pa_obs_main(["bundle", path]) == 0
        out = capsys.readouterr().out
        assert "unit-test" in out and "timeline:" in out
        # the bundled journal copy is itself a valid pa-obs target
        assert pa_obs_main(["lint", os.path.join(path, "journal")]) == 0
    finally:
        guard.disable()

# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------


def _hostile_dirs(root):
    """Directories of hostile journals: torn tail, rotated segments, a
    missing rank, skew fixed by markers, skew fixed by clock.sync."""
    out = {}
    d = os.path.join(root, "torn")
    _write_journal(d, 0, [_hop(0, 1, 10.0), _hop(0, 2, 11.0)])
    with open(os.path.join(d, "journal.r0.jsonl"), "a") as f:
        f.write('{"v":2,"ev":"hop","proc":0,"t_wa')
    out["torn"] = d
    d = os.path.join(root, "rotated")
    for k in range(1, 11):
        _write_journal(d, 0, [_hop(0, k, 10.0)], segment=k)
    _write_journal(d, 0, [_hop(0, 11, 10.0)])
    out["rotated"] = d
    d = os.path.join(root, "missing")
    _write_journal(d, 0, [_hop(0, 1, 10.0)])
    _write_journal(d, 2, [_hop(2, 1, 10.0, dispatch_s=0.9)])
    open(os.path.join(d, "journal.r3.jsonl"), "w").close()
    out["missing"] = d
    d = os.path.join(root, "skew")
    marker = dict(reason="verdict:retry")
    for r, dt in ((0, 0.0), (1, 3600.0)):
        _write_journal(d, r, [
            _hop(r, 1, 100.0 + 0.2 * r + dt),
            _rec(r, 2, "guard.epoch", 101.0 + 0.1 * r + dt, epoch=1,
                 **marker),
            _hop(r, 3, 102.0 + 0.3 * r + dt, epoch=1,
                 dispatch_s=0.001 + 0.5 * r)])
    out["skew"] = d
    d = os.path.join(root, "sync")
    _write_journal(d, 0, [_hop(0, 1, 100.0)])
    _write_journal(d, 1, [
        _rec(1, 1, "clock.sync", 160.0, ref_rank=0, offset_s=60.0,
             method="kv"),
        _hop(1, 2, 160.5)])
    out["sync"] = d
    return out


def _same_merge(d, skew=True):
    mine = obs_timeline.merge_journals(d, correct_skew=skew)
    theirs = jax_timeline.merge_journals(d, correct_skew=skew)
    for field in ("events", "ranks", "missing_ranks", "warnings",
                  "offsets", "offset_method"):
        assert getattr(mine, field) == getattr(theirs, field), (d, field)
    assert obs_timeline.to_trace(mine) == jax_timeline.to_trace(theirs)
    assert obs_timeline.render(mine) == jax_timeline.render(theirs)
    assert obs_straggler.detect_from_events(mine.events) == \
        jax_straggler.detect_from_events(theirs.events)
    return mine


def test_merge_matches_jax_on_hostile_journals(tmp_path):
    for name, d in _hostile_dirs(str(tmp_path)).items():
        _same_merge(d)
        _same_merge(d, skew=False)


def _cli_same(argv, capsys):
    capsys.readouterr()
    rc = pa_obs_main(argv)
    mine = capsys.readouterr()
    assert rc == jax_main(argv), argv
    assert mine == capsys.readouterr(), argv
    return rc


def test_cli_outputs_match_jax(tmp_path, capsys):
    dirs = _hostile_dirs(str(tmp_path))
    for name, d in dirs.items():
        for cmd in ("lint", "timeline", "requests"):
            _cli_same([cmd, d], capsys)
        _cli_same(["lint", d, "--no-skew-correct"], capsys)
        for cmd in ("merge", "trace"):
            a, b = str(tmp_path / f"{name}.a"), str(tmp_path / f"{name}.b")
            assert pa_obs_main([cmd, d, "-o", a]) == \
                jax_main([cmd, d, "-o", b]) == 0
            with open(a) as fa, open(b) as fb:
                assert fa.read() == fb.read(), (name, cmd)
    d = str(tmp_path / "snap")
    obs_drift.drift_tracker.record("hopA", 100, 1.0, source="benchtime")
    obs_drift.drift_tracker.record("hopB", 0, 0.5, source="dispatch")
    obs.write_snapshot(os.path.join(d, "metrics.json"))
    _cli_same(["drift", d], capsys)
    assert _cli_same(["drift", str(tmp_path / "none")], capsys) == 1
    assert _cli_same(["bundle", str(tmp_path / "none")], capsys) == 1


def test_jax_journal_merges_and_lints_in_the_port(tmp_path, devices):
    """A journal the JAX package wrote (hops on its 8-device mesh, a
    plan, a drift sample) merges and lints clean in the port, with the
    JAX package's own merge."""
    d = str(tmp_path / "jax")
    jobs.enable(d)
    try:
        import pencilarrays_tpu as jpa

        topo = jpa.Topology((2, 4), devices=devices)
        px = jpa.Pencil(topo, (16, 12, 10), (1, 2))
        x = jpa.PencilArray.zeros(px)
        for _ in range(2):
            jpa.transpose(x, px.replace(decomp_dims=(0, 2)))
        jpa.PencilFFTPlan(topo, (16, 12, 10), real=True)
        jobs.record_hop_sample("hopA", 100, 1.0, source="benchtime")
    finally:
        jobs.disable()
    mine = _same_merge(d)
    assert obs.lint_journal(mine.events) == []
    assert {"hop", "plan.build", "drift.sample"} <= {
        e["ev"] for e in mine.events}


def test_port_journal_merges_and_lints_in_jax(tmp_path):
    """A journal the port wrote (hops, a plan, a route plan, guard
    records, a drift sample) merges and lints clean in the JAX package,
    equal to the port's own merge."""
    from pencilarrays_tpu.obs import schema as jax_schema
    from pencilarrays_tpu_torch import guard
    from pencilarrays_tpu_torch.guard import IntegrityError
    from pencilarrays_tpu_torch.resilience import faults

    d = str(tmp_path / "torch")
    obs.enable(d)
    guard._reset_for_tests()
    guard.enable(str(tmp_path / "bundles"))
    try:
        topo = pa.Topology((1, 1), device="cpu")
        px = pa.Pencil(topo, (16, 12, 10), (1, 2))
        x = pa.PencilArray.zeros(px)
        pa.transpose(x, px.replace(decomp_dims=(0, 2)))
        pa.reshard(x, px.replace(decomp_dims=(2, 0)), method=pa.AllToAll())
        pa.PencilFFTPlan(topo, (16, 12, 10), real=True)
        with faults.active("hop.exchange:corrupt"):
            with pytest.raises(IntegrityError):
                pa.transpose(x, px.replace(decomp_dims=(0, 2)))
        obs_drift.measure_transpose(x, px.replace(decomp_dims=(0, 2)),
                                    k0=1, k1=2, repeats=1)
    finally:
        guard._reset_for_tests()
        faults.clear()
        obs.disable()
    mine = _same_merge(d)
    assert jax_schema.lint_journal(mine.events) == []
    assert jax_schema.lint_journal(d) == []
    assert {"hop", "plan.build", "route.plan", "guard.sdc", "guard.bundle",
            "fault", "drift.sample"} <= {e["ev"] for e in mine.events}


def test_straggler_flagged_across_four_gloo_ranks(tmp_path):
    """Rank 1 of 4 gloo ranks dragged by ``hop.exchange:delay%rank1``:
    the merged journals name it, in both packages' merge and rule (the
    hops are local permutes, so no rank waits for another's stall)."""
    pool = tasks.shared_pool()
    d = str(tmp_path / "obs")
    got = pool.run(tasks.straggler_case, (2, 2), (8, 6, 4), d)[0]
    assert got["ranks"] == [0, 1, 2, 3] and got["warnings"] == []
    assert [f["rank"] for f in got["flags"]] == [1]
    assert got["flags"][0]["excess_s"] > 0.2
    mine = _same_merge(d)
    assert obs.lint_journal(mine.events) == []


def test_single_rank_straggler_and_aggregator(tmp_path, monkeypatch):
    """One rank: the straggler rule skips (nothing to compare against);
    the aggregator over ``FileKV`` at world 1 writes mesh_metrics.json
    and the Prometheus text with ``rank`` labels."""
    monkeypatch.setenv(obs.ENV_VAR, str(tmp_path / "obs"))
    topo = pa.Topology((1, 1), device="cpu")
    px = pa.Pencil(topo, (8, 6, 4), (1, 2))
    pa.transpose(pa.PencilArray.zeros(px), px.replace(decomp_dims=(0, 2)))
    snap = obs.snapshot()
    assert obs_straggler.scan_snapshots({0: snap}) == []
    events = obs.read_journal()
    assert obs_straggler.detect_from_events(events) == []
    agg = obs_agg.MeshAggregator(FileKV(str(tmp_path / "kv")), 0, 1,
                                 cadence=60)
    assert agg.publish_once()
    fold = agg.fold_once(wait=True, timeout=5)
    assert fold["ranks"] == [0] and fold["missing_ranks"] == []
    with open(os.path.join(str(tmp_path / "obs"), "mesh_metrics.prom")) as f:
        prom = f.read()
    assert 'rank="0"' in prom and "pa_transpose_dispatches_total" in prom
    with open(os.path.join(str(tmp_path / "obs"), "mesh_metrics.json")) as f:
        assert json.load(f)["ranks"] == [0]
    from pencilarrays_tpu.obs import aggregate as jax_agg

    assert jax_agg.mesh_prometheus({0: snap}) == \
        obs_agg.mesh_prometheus({0: snap})
