"""PyTorch port vs JAX package: the core of ``obs/`` (``tests/test_obs.py``).

The journal is one format: a journal the port writes lints clean under
the JAX package's ``lint_journal`` and the reverse, with the same schema
version, event registry and critical set; the same instruments give the
same metrics snapshot keys and the same Prometheus text; ``span`` and
``io_op`` journal and meter alike in both packages; ``profile`` writes a
Chrome trace and the JAX package's capture stamp.  No tolerance applies:
these are record shapes, compared key by key.
"""

import json
import math
import os

import numpy as np
import pytest

import pencilarrays_tpu.obs as jobs
from pencilarrays_tpu.obs import events as jax_events
from pencilarrays_tpu.obs import metrics as jax_metrics
from pencilarrays_tpu.obs import drift as jax_drift
from pencilarrays_tpu.obs import schema as jax_schema
from pencilarrays_tpu.obs import straggler as jax_straggler
import pencilarrays_tpu_torch as pat
import torch_rank_tasks as tasks
import pencilarrays_tpu_torch.obs as pobs
from pencilarrays_tpu_torch.obs import drift as drift
from pencilarrays_tpu_torch.obs import events as events
from pencilarrays_tpu_torch.obs import metrics as metrics
from pencilarrays_tpu_torch.obs import schema as schema
from pencilarrays_tpu_torch.obs import straggler as straggler

# fields whose values differ run to run (ids, clocks, sequence numbers)
VOLATILE = {"run", "t_wall", "t_mono", "seq", "pid", "argv", "seconds",
            "path", "dir"}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("PENCILARRAYS_TPU_OBS", raising=False)
    events._reset_for_tests()
    jax_events._reset_for_tests()
    metrics.registry.reset()
    jax_metrics.registry.reset()
    drift.drift_tracker.reset()
    jax_drift.drift_tracker.reset()
    yield
    events._reset_for_tests()
    jax_events._reset_for_tests()
    metrics.registry.reset()
    jax_metrics.registry.reset()
    drift.drift_tracker.reset()
    jax_drift.drift_tracker.reset()


def _load(path):
    with open(path) as f:
        return json.load(f)


def test_schema_tables_match_jax():
    assert events.SCHEMA_VERSION == jax_events.SCHEMA_VERSION
    assert events.CRITICAL_EVENTS == jax_events.CRITICAL_EVENTS
    assert schema.COMMON_FIELDS == jax_schema.COMMON_FIELDS
    assert schema.EVENT_TYPES == jax_schema.EVENT_TYPES
    for name in ("V2_STAMP_FIELDS", "V3_EVENT_FIELDS", "V4_EVENT_FIELDS",
                 "V5_EVENT_FIELDS", "V6_EVENT_FIELDS", "V7_EVENT_FIELDS",
                 "V8_EVENT_FIELDS"):
        assert getattr(schema, name) == getattr(jax_schema, name), name


def _script(o):
    """The same telemetry through either package's ``obs``."""
    o.record_event("ckpt.save", step=3, status="start")
    o.record_event("ckpt.commit", step=3)
    o.record_event("fault", point="barrier", mode="error", hit=1)
    o.record_event("engine.reform", gen=1, stage="complete", name="e",
                   dropped=0, dropped_host=0, dropped_lanes={})
    with o.io_op("io.write", "binary", "/x/f.bin", "u", nbytes=4096,
                 shape=[8, 8, 16]):
        pass
    with pytest.raises(OSError):
        with o.io_op("io.read", "binary", "/x/f.bin", "u"):
            raise OSError("disk gone")
    with o.span("pack data"):
        pass
    with o.step() as k:
        o.record_event("retry", label="x", attempt=k, max_attempts=2,
                       delay_s=0.0, error="e")
    o.counter("engine.reforms").inc()
    o.gauge("engine.lanes", engine="e", lane="1", state="queued").set(3)
    o.histogram("transpose.dispatch_seconds", method="AllToAll").observe(
        0.25)
    o.record_event("run.stop")


def _shapes(recs):
    return [{k: (None if k in VOLATILE else v) for k, v in e.items()}
            for e in recs]


def test_journals_cross_lint_and_match(tmp_path):
    pobs.enable(str(tmp_path / "torch"))
    _script(pobs)
    pobs.disable()
    jobs.enable(str(tmp_path / "jax"))
    _script(jobs)
    jobs.disable()
    mine = pobs.read_journal(str(tmp_path / "torch"))
    theirs = jobs.read_journal(str(tmp_path / "jax"))
    assert os.listdir(tmp_path / "torch") == os.listdir(tmp_path / "jax")
    # each package's linter reads the other's journal clean
    assert jax_schema.lint_journal(str(tmp_path / "torch")) == []
    assert schema.lint_journal(str(tmp_path / "jax")) == []
    assert schema.lint_journal(mine) == []
    assert _shapes(mine) == _shapes(theirs)
    io = [e for e in mine if e["ev"].startswith("io.")]
    assert [(e["ev"], e["ok"]) for e in io] == [("io.write", True),
                                                 ("io.read", False)]
    assert "OSError: disk gone" in io[1]["error"]


def test_lint_catches_what_jax_catches():
    bad = [{"v": 8, "ev": "ckpt.commit", "run": "r", "proc": 0, "seq": 1,
            "t_wall": 0.0, "t_mono": 0.0, "step_idx": 0, "epoch": 0},
           {"v": 99, "ev": "nope", "run": "r"},
           {"v": 8, "ev": "serve.precision", "run": "r", "proc": 0,
            "seq": 2, "t_wall": 0.0, "t_mono": 0.0, "step_idx": 0,
            "epoch": 0, "tenant": "t", "req": 1, "key": "k", "gate": "g"}]
    assert schema.lint_journal(bad) == jax_schema.lint_journal(bad)
    assert len(schema.lint_journal(bad)) >= 4


def test_metrics_snapshot_and_prometheus_match(tmp_path):
    for o in (pobs, jobs):
        o.counter("io.bytes_written", driver="binary").inc(4096)
        o.counter("engine.callback_errors").inc()
        o.gauge("engine.ready_tasks", engine="default").set(2)
        o.gauge("unset.gauge")
        h = o.histogram("span.seconds", label="a\"b\nc")
        for v in (1e-6, 0.5, 3.0, 0.0):
            h.observe(v)
    mine, theirs = pobs.snapshot(), jobs.snapshot()
    assert set(mine) == set(theirs)
    for key in ("counters", "gauges", "histograms", "series", "format",
                "version"):
        assert mine[key] == theirs[key], key
    assert pobs.to_prometheus() == jobs.to_prometheus()
    path = pobs.write_prometheus(str(tmp_path / "m.prom"))
    with open(path) as f:
        assert f.read() == jobs.to_prometheus()
    snap = pobs.write_snapshot(str(tmp_path / "m.json"))
    assert _load(snap)["counters"] == mine["counters"]


def test_disabled_records_nothing(tmp_path):
    assert not pobs.enabled()
    assert pobs.record_event("ckpt.commit", step=1) is False
    assert pobs.write_snapshot() is None
    with pobs.io_op("io.write", "binary", "p", "u", nbytes=8):
        pass
    assert pobs.snapshot()["counters"] == {}


def test_env_value_is_the_journal_dir(tmp_path, monkeypatch):
    d = str(tmp_path / "j")
    monkeypatch.setenv("PENCILARRAYS_TPU_OBS", d)
    assert pobs.enabled() and pobs.journal_dir() == d
    assert pobs.record_event("ckpt.commit", step=1)
    assert [e["ev"] for e in pobs.read_journal(d)] == ["run.start",
                                                        "ckpt.commit"]
    monkeypatch.setenv("PENCILARRAYS_TPU_OBS", "1")
    monkeypatch.setenv("PENCILARRAYS_TPU_OBS_DIR", str(tmp_path / "k"))
    assert pobs.journal_dir() == str(tmp_path / "k")


def test_rotation_keeps_every_record(tmp_path, monkeypatch):
    monkeypatch.setenv("PENCILARRAYS_TPU_OBS_MAX_MB", "0.001")
    pobs.enable(str(tmp_path))
    for i in range(40):
        pobs.record_event("ckpt.gc", removed=[i])
    pobs.disable()
    names = sorted(os.listdir(tmp_path))
    assert len(names) > 1 and "journal.r0.jsonl" in names
    recs = pobs.read_journal(str(tmp_path))
    assert [e["removed"] for e in recs if e["ev"] == "ckpt.gc"] == [
        [i] for i in range(40)]
    assert jax_schema.lint_journal(str(tmp_path)) == []


def test_profile_writes_a_chrome_trace_and_the_stamp(tmp_path):
    topo = pat.Topology((1, 1), device="cpu")
    plan = pat.PencilFFTPlan(topo, (8, 6, 4), real=True)
    pobs.enable(str(tmp_path / "j"))
    u = plan.allocate_input()
    with pobs.profile(str(tmp_path / "cap"), plan=plan, note="x") as prof:
        plan.forward(u)
    pobs.disable()
    assert prof is not None
    trace = _load(tmp_path / "cap" / "trace.json")
    assert trace.get("traceEvents")
    stamp = _load(tmp_path / "cap" / "pa_capture_metadata.json")
    assert stamp["metadata"] == {"note": "x"}
    assert stamp["plan"]["transforms"] == list(plan.transforms)
    assert stamp["plan"]["predicted_costs"] == {}
    evs = [e for e in pobs.read_journal(str(tmp_path / "j"))
           if e["ev"] == "profile"]
    assert [e["status"] for e in evs] == ["start", "stop"]


# -- the drift tracker (tests/test_obs.py) -------------------------------------


def _close(a, b, rel=1e-12):
    """Reports equal, floats within ``rel`` relative."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (a, b)
        for k in a:
            _close(a[k], b[k], rel)
    elif isinstance(a, float) or isinstance(b, float):
        assert math.isclose(a, b, rel_tol=rel, abs_tol=0.0), (a, b)
    else:
        assert a == b, (a, b)


SAMPLES = [
    [("A", 100, 1.0, "benchtime"), ("B", 300, 3.0, "benchtime"),
     ("B", 300, 9.0, "benchtime"), ("C", 100, 3.0, "benchtime")],
    [("A", 100, 50.0, "dispatch"), ("A", 100, 1.0, "benchtime"),
     ("A", 100, 70.0, "dispatch"), ("L", 0, 1.0, "dispatch")],
    [("D1", 100, 0.001, "dispatch"), ("T1", 100, 1.0, "benchtime"),
     ("M", 777, 0.37, "auto_measure"), ("M", 777, 0.11, "dispatch")],
]


@pytest.mark.parametrize("samples", SAMPLES, ids=["fit", "rank", "class"])
def test_drift_report_matches_jax(samples):
    mine, theirs = drift.DriftTracker(), jax_drift.DriftTracker()
    for hop, nbytes, secs, source in samples:
        mine.record(hop, nbytes, secs, source=source)
        theirs.record(hop, nbytes, secs, source=source)
        assert mine.version() == theirs.version()
        _close(mine.report(), theirs.report())


def test_drift_arithmetic_synthetic():
    t = drift.DriftTracker()
    t.record("A", 100, 1.0, source="benchtime")
    t.record("B", 300, 3.0, source="benchtime")
    rep = t.report()
    assert rep["fitted_bytes_per_s"] == pytest.approx(100.0)
    assert rep["hops"]["B"]["drift"] == pytest.approx(1.0)
    t.record("B", 300, 9.0, source="benchtime")
    rep = t.report()
    assert rep["hops"]["B"]["measured_s"] == pytest.approx(3.0)
    assert rep["hops"]["B"]["count"] == 2
    assert rep["hops"]["B"]["last_s"] == pytest.approx(9.0)
    t.record("C", 100, 3.0, source="benchtime")
    rep = t.report()
    assert rep["fitted_bytes_per_s"] == pytest.approx(500.0 / 7.0)
    assert rep["hops"]["C"]["drift"] == pytest.approx(15.0 / 7.0)


def test_drift_source_ranking_zero_bytes_and_classes():
    t = drift.DriftTracker()
    t.record("A", 100, 50.0, source="dispatch")
    t.record("A", 100, 1.0, source="benchtime")
    assert t.report()["hops"]["A"]["source"] == "benchtime"
    t.record("L", 0, 1.0, source="dispatch")
    assert t.report()["hops"]["L"]["drift"] is None
    with pytest.raises(ValueError):
        t.record("A", 1, 1.0, source="bogus")
    t = drift.DriftTracker()
    t.record("D1", 100, 0.001, source="dispatch")
    t.record("T1", 100, 1.0, source="benchtime")
    rep = t.report()
    assert rep["fitted_bytes_per_s"] == pytest.approx(100.0)
    assert rep["dispatch_fitted_bytes_per_s"] == pytest.approx(1e5)
    assert rep["hops"]["T1"]["drift"] == pytest.approx(1.0)


def test_drift_version_counts_trusted_samples_only():
    t = drift.DriftTracker()
    assert t.version() == 0
    t.record("A", 1, 1.0, source="dispatch")
    assert t.version() == 0
    t.record("A", 1, 1.0, source="auto_measure")
    assert t.version() == 1
    t.reset()
    assert t.version() == 2 and t.report()["hops"] == {}


def test_drift_in_snapshot_and_prometheus_match_jax():
    for o, t in ((pobs, drift.drift_tracker),
                 (jobs, jax_drift.drift_tracker)):
        o.counter("cluster.stragglers", rank="1").inc()
        t.record("hopA", 100, 1.0, source="benchtime")
        t.record("hopB", 300, 3.0, source="benchtime")
        t.record("hopC", 50, 0.2, source="dispatch")
    assert pobs.to_prometheus() == jobs.to_prometheus()
    text = pobs.to_prometheus()
    assert 'pa_drift{hop="hopA",source="benchtime"} 1' in text
    assert 'pa_drift_fitted_bytes_per_s{class="device"} 100' in text
    _close(pobs.snapshot()["drift"], jobs.snapshot()["drift"])


def test_dispatch_feeds_drift_and_measure_transpose(devices, tmp_path):
    """On 4 gloo ranks: a hop's ``dispatch`` sample carries the JAX
    package's hop label and predicted bytes (its ``transpose_cost`` on a
    4-device mesh), and ``measure_transpose`` upgrades the hop's source
    to ``benchtime``, journaling a ``drift.sample``."""
    import pencilarrays_tpu as jpa

    pool = tasks.shared_pool()
    shape = (16, 12, 10)
    got = pool.run(tasks.drift_case, (2, 2), shape, str(tmp_path))[0]
    jt = jpa.Topology((2, 2), devices=devices[:4])
    jin = jpa.Pencil(jt, shape, (1, 2))
    jout = jpa.Pencil(jt, shape, (0, 2))
    label = jpa.parallel.transpositions._hop_label(jin, jout, jpa.AllToAll(),
                                                   np.float32)
    nbytes = sum(v["bytes"] for v in jpa.transpose_cost(
        jin, jout, (), np.float32, jpa.AllToAll()).values())
    (hop, entry), = got["after_hop"]["hops"].items()
    assert hop == label and entry["source"] == "dispatch"
    assert entry["predicted_bytes"] == nbytes > 0
    assert got["measured"]["hop"] == label
    assert got["measured"]["predicted_bytes"] == nbytes
    assert got["after_measure"]["hops"][label]["source"] == "benchtime"
    assert {"hop", "drift.sample"} <= set(got["events"])


STRAGGLER_CASES = [
    {0: {"H": 0.002}, 1: {"H": 0.302}},
    {0: {"H": 0.0020}, 1: {"H": 0.0021}},
    {**{r: {"H": 0.010 + 0.0001 * r} for r in range(7)}, 3: {"H": 0.5}},
    {0: {"H": 0.1}, 1: {"H": 0.4}, 2: {"H": 0.7}, 3: {"H": 1.0},
     4: {"H": 1.3}},
    {0: {"H": 9.0}},
    {0: {"A": 9.0}, 1: {"B": 0.1}},
]


@pytest.mark.parametrize("durations", STRAGGLER_CASES)
def test_straggler_rule_matches_jax(durations):
    assert straggler.detect(durations) == jax_straggler.detect(durations)
    assert straggler._median([3.0, 1.0, 2.0, 10.0]) == \
        jax_straggler._median([3.0, 1.0, 2.0, 10.0])

