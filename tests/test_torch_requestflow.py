"""PyTorch port vs JAX package: request-scoped reconstruction
(``obs/requestflow.py``, the cases of ``tests/test_requestflow.py``).

The same synthetic journals (a router and a mesh rank, three requests
coalescing into one dispatch; a missing mesh journal; torn tails;
traceless v5 journals) go through both packages' ``reconstruct_request``
/ ``list_requests`` / renderers and both ``pa-obs`` command lines: the
port's answers, warnings, texts and exit codes must equal the JAX
package's exactly (no tolerance: these are records and strings).  The
serve layer's burn-rate monitor is ported with the serve layer; its
cases are held in ``tests/test_torch_slo.py``.  The real-dispatch case
runs one engine dispatch of the port with a minted trace in its meta.
"""

import json
import os

import numpy as np
import pytest

from pencilarrays_tpu.obs import events as jax_events
from pencilarrays_tpu.obs import requestflow as jrf
from pencilarrays_tpu.obs.__main__ import main as jax_main
import pencilarrays_tpu_torch as pat
from pencilarrays_tpu_torch import obs
from pencilarrays_tpu_torch.obs import events as obs_events
from pencilarrays_tpu_torch.obs import metrics as obs_metrics
from pencilarrays_tpu_torch.obs.__main__ import main
from pencilarrays_tpu_torch.obs.requestflow import (
    RequestTrace,
    list_requests,
    mint_trace,
    reconstruct_request,
    render_index,
    render_request,
)
from pencilarrays_tpu_torch.obs.schema import lint_journal


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv(obs.ENV_VAR, raising=False)
    obs_events._reset_for_tests()
    jax_events._reset_for_tests()
    obs_metrics.registry.reset()
    yield
    obs_events._reset_for_tests()
    jax_events._reset_for_tests()
    obs_metrics.registry.reset()


def _rec(proc, seq, t, ev, v=6, **fields):
    rec = {"v": v, "ev": ev, "run": f"run-r{proc}", "proc": proc,
           "seq": seq, "t_wall": t, "t_mono": t,
           "step_idx": 0, "epoch": 0}
    rec.update(fields)
    return rec


def _write_rank(directory, proc, records):
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"journal.r{proc}.jsonl")
    with open(path, "a") as f:
        for r in records:
            f.write(json.dumps(r, separators=(",", ":")) + "\n")
    return path


A, B, C = "aaaa000011112222", "bbbb000011112222", "cccc000011112222"


def _mesh_story(t0=100.0):
    recs = [_rec(1, 1, t0, "run.start", pid=1)]
    for i, tr in enumerate((A, B, C)):
        recs.append(_rec(1, 2 + i, t0 + 0.01 * i, "serve.request",
                         tenant="acme", req=i, kind="fft", key="k",
                         nbytes=1024, trace=tr))
    recs.append(_rec(1, 5, t0 + 0.05, "serve.coalesce", key="k", n=3,
                     reqs=[0, 1, 2], reason="full", wait_s=0.04,
                     trace=A, traces=[A, B, C]))
    recs.append(_rec(1, 6, t0 + 0.06, "serve.dispatch", key="k", n=3,
                     tenants=["acme"], score_bytes=3072, reason="full",
                     lane=0, chain="*", trace=A, traces=[A, B, C]))
    for i, tr in enumerate((A, B, C)):
        recs.append(_rec(1, 7 + i, t0 + 0.2 + 0.01 * i, "serve.complete",
                         tenant="acme", req=i, outcome="ok",
                         seconds=0.1, key="k", trace=tr))
    return recs


def _router_story(t0=100.0):
    recs = [_rec(0, 1, t0 - 1.0, "run.start", pid=0)]
    for i, tr in enumerate((A, B, C)):
        recs.append(_rec(0, 2 + i, t0 - 0.5 + 0.01 * i, "fleet.route",
                         ticket=f"t{i}", tenant="acme", mesh=1,
                         reason="placed", score_bytes=1024, trace=tr))
    return recs


def _same_as_jax(d, traces, capsys):
    """Every trace's reconstruction, the index and both command lines'
    outputs equal the JAX package's on directory ``d``."""
    for tr in traces:
        mine, my_w = reconstruct_request(d, tr)
        theirs, their_w = jrf.reconstruct_request(d, tr)
        assert my_w == their_w
        assert (mine is None) == (theirs is None)
        if mine is not None:
            assert mine.__dict__ == theirs.__dict__
            assert render_request(mine) == jrf.render_request(theirs)
    mine, my_w = list_requests(d)
    theirs, their_w = jrf.list_requests(d)
    assert (mine, my_w) == (theirs, their_w)
    assert render_index(mine) == jrf.render_index(theirs)
    for argv in [["requests", d]] + [["request", d, t] for t in traces]:
        capsys.readouterr()
        rc = main(argv)
        out = capsys.readouterr()
        assert rc == jax_main(argv), argv
        assert out == capsys.readouterr(), argv


def test_synthetic_fan_in_shared_dispatch_span(tmp_path, capsys):
    d = str(tmp_path / "obs")
    _write_rank(d, 0, _router_story())
    _write_rank(d, 1, _mesh_story())
    assert lint_journal(obs_events.read_journal(d)) == []
    for tr in (A, B, C):
        rt, warnings = reconstruct_request(d, tr)
        assert isinstance(rt, RequestTrace) and rt.trace == tr
        assert warnings == [] and rt.fan_in == 3 and rt.ranks == [0, 1]
        assert rt.outcome == "ok" and rt.tenant == "acme"
        evs = [e["ev"] for e in rt.events]
        for ev in ("fleet.route", "serve.coalesce", "serve.dispatch",
                   "serve.complete"):
            assert evs.count(ev) == 1, ev
        assert {"wire_s", "admission_wait_s", "coalesce_wait_s",
                "compute_s", "lane_wait_s"} <= set(rt.critical_path)
        assert rt.critical_path["compute_s"] == pytest.approx(0.1)
        text = render_request(rt)
        assert tr in text and "critical path:" in text
    rt_a, _ = reconstruct_request(d, A)
    rt_b, _ = reconstruct_request(d, B)
    disp_a = next(e for e in rt_a.events if e["ev"] == "serve.dispatch")
    disp_b = next(e for e in rt_b.events if e["ev"] == "serve.dispatch")
    assert disp_a["seq"] == disp_b["seq"] == 6
    summaries, warnings = list_requests(d)
    assert warnings == [] and [s["trace"] for s in summaries] == [A, B, C]
    assert all(s["events"] == 5 and s["outcome"] == "ok"
               and s["ranks"] == [0, 1] for s in summaries)
    assert A in render_index(summaries)
    _same_as_jax(d, (A, B, C), capsys)


def test_missing_mesh_journal_degrades_to_warnings(tmp_path, capsys):
    d = str(tmp_path / "obs")
    _write_rank(d, 0, _router_story())
    _write_rank(d, 2, [_rec(2, 1, 99.5, "run.start", pid=2)])
    rt, warnings = reconstruct_request(d, A)
    assert rt is not None and rt.trace == A and rt.ranks == [0]
    assert rt.outcome is None and rt.fan_in is None
    assert any("rank 1: no journal found" in w for w in warnings)
    assert any("no serve.request record" in w for w in warnings)
    assert any("no serve.complete record" in w for w in warnings)
    assert main(["request", d, A]) == 0
    assert main(["requests", d]) == 0
    assert main(["request", d, "feedfacedeadbeef"]) == 1
    _same_as_jax(d, (A, "feedfacedeadbeef"), capsys)


def test_torn_tail_degrades_to_warnings(tmp_path, capsys):
    d = str(tmp_path / "obs")
    _write_rank(d, 0, _router_story())
    path = _write_rank(d, 1, _mesh_story())
    with open(path) as f:
        lines = f.read().splitlines()
    lines[3] = lines[3][: len(lines[3]) // 2]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n" + '{"v":6,"ev":"serve.comp')
    rt, warnings = reconstruct_request(d, A)
    assert rt is not None and rt.outcome == "ok"
    assert any("torn final line" in w for w in warnings)
    assert any("unparseable mid-file" in w for w in warnings)
    assert main(["request", d, A]) == 0
    assert main(["requests", d]) == 0
    _same_as_jax(d, (A, B), capsys)


def test_v5_journals_stay_clean_and_traceless(tmp_path, capsys):
    d = str(tmp_path / "obs")
    _write_rank(d, 0, [
        _rec(0, 1, 10.0, "run.start", v=5, pid=0),
        _rec(0, 2, 10.1, "serve.request", v=5, tenant="acme", req=0,
             kind="fft", key="k", nbytes=64),
        _rec(0, 3, 10.2, "serve.dispatch", v=5, key="k", n=1,
             tenants=["acme"], score_bytes=64, reason="full",
             lane=0, chain="*"),
        _rec(0, 4, 10.3, "serve.complete", v=5, tenant="acme", req=0,
             outcome="ok", seconds=0.05, key="k"),
    ])
    assert lint_journal(obs_events.read_journal(d)) == []
    summaries, warnings = list_requests(d)
    assert summaries == [] and warnings == []
    assert "no traced requests" in render_index(summaries)
    assert reconstruct_request(d, A)[0] is None
    assert main(["requests", d]) == 0
    assert main(["request", d, A]) == 1
    _same_as_jax(d, (A,), capsys)
    empty = str(tmp_path / "nothing")
    os.makedirs(empty)
    rt, warnings = reconstruct_request(empty, A)
    assert rt is None and any("no journal files" in w for w in warnings)
    assert main(["request", empty, A]) == 1
    assert main(["requests", empty]) == 0
    _same_as_jax(empty, (A,), capsys)


def test_engine_dispatch_reconstructs(tmp_path, capsys):
    """One engine dispatch carrying a minted trace: the records written
    inside it (the hop, the fault) carry the trace, and the request
    reconstructs from the journal in both packages alike."""
    from pencilarrays_tpu_torch.engine import Engine
    from pencilarrays_tpu_torch.resilience import faults

    jdir = str(tmp_path / "obs")
    obs.enable(jdir)
    topo = pat.Topology((1, 1), device="cpu")
    px = pat.Pencil(topo, (8, 6, 4), (1, 2))
    py = pat.Pencil(topo, (8, 6, 4), (0, 2))
    u = pat.PencilArray.from_global(px, np.arange(192.0).reshape(8, 6, 4))
    tr = mint_trace()
    e = Engine("rf")
    try:
        with faults.active("hop.exchange:delay"):
            out = e.submit(lambda: pat.transpose(u, py), label="hop",
                           meta={"trace": tr}).result()
    finally:
        e.close()
        obs.disable()
    np.testing.assert_array_equal(pat.gather(out),
                                  np.arange(192.0).reshape(8, 6, 4))
    events = obs_events.read_journal(jdir)
    assert lint_journal(events) == []
    mine = [x["ev"] for x in events if x.get("trace") == tr]
    assert {"hop", "fault"} <= set(mine)
    rt, _ = reconstruct_request(jdir, tr)
    assert rt is not None and rt.ranks == [0]
    assert [x["ev"] for x in rt.events] == mine
    assert main(["request", jdir, tr]) == 0
    _same_as_jax(jdir, (tr,), capsys)
