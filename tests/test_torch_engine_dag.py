"""PyTorch port vs JAX package: the engine's task DAG and the partial-order
certification of its dispatch log (``tests/test_engine_dag.py``).

Two halves, each run through BOTH packages:

* forged dispatch logs (in-chain inversion, cross-chain reorder, scrubbed
  deps, a barrier issued late, a duplicate seq, a forged resource set, an
  all-barrier log) get the same ``verify_dispatch_log`` verdict from the
  JAX package and from the port: the same error type and attributes, or
  the same result dict;
* the same scripted submissions (disjoint chains, lanes, the starvation
  bound, ``after=`` edges, the DAG switched off, a reform dropping held
  lanes, a failed pack inside a chain) go through the JAX ``Engine`` and
  the port's ``Engine``, and the dispatch logs agree: issue order,
  outcome, chain, barrier, reads and writes.  A barrier holds each
  engine's consumer until the script has queued everything, so the
  order is the scheduler's; the scripts' sleeps (0.1–0.3 s, the JAX
  tests' own) order work that runs while later work queues.
"""

import threading
import time

import pytest

import pencilarrays_tpu.analysis.spmd as jax_spmd
import pencilarrays_tpu.engine as jax_engine
from pencilarrays_tpu.obs import events as jax_obs_events
import pencilarrays_tpu_torch.analysis.spmd as spmd
import pencilarrays_tpu_torch.engine as engine
from pencilarrays_tpu_torch.engine import config as eng_config
from pencilarrays_tpu_torch.obs import events as obs_events

PKGS = {"torch": (engine, spmd), "jax": (jax_engine, jax_spmd)}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in (eng_config.ENGINE_WORKERS_VAR, eng_config.ENGINE_DAG_VAR,
                eng_config.ENGINE_STARVE_VAR, "PENCILARRAYS_TPU_OBS"):
        monkeypatch.delenv(var, raising=False)
    obs_events._reset_for_tests()
    jax_obs_events._reset_for_tests()
    yield
    obs_events._reset_for_tests()
    jax_obs_events._reset_for_tests()


# -- forged logs -----------------------------------------------------------------


class _StubPlan:
    def plan_key(self):
        return "feedc0de"


def _rec(mod, enqueue_seq, issue_seq, label, **kw):
    kw.setdefault("outcome", "ok")
    return mod.DispatchRecord(enqueue_seq=enqueue_seq, issue_seq=issue_seq,
                              label=label, queued_s=0.0, run_s=0.0,
                              outcome=kw.pop("outcome"), **kw)


def _chain(mod, enqueue_seq, issue_seq, label, res, deps=()):
    return _rec(mod, enqueue_seq, issue_seq, label, barrier=False,
                chain=res, writes=(res,), deps=tuple(deps))


LOGS = {
    "total_order": lambda m: [_rec(m, i, i, f"s{i}") for i in range(1, 5)],
    "total_inversion": lambda m: [_rec(m, 1, 1, "s1"), _rec(m, 3, 2, "s3"),
                                  _rec(m, 2, 3, "s2"), _rec(m, 4, 4, "s4")],
    "cross_chain_reorder": lambda m: [
        _chain(m, 2, 1, "b1", "b"), _chain(m, 1, 2, "a1", "a"),
        _chain(m, 3, 3, "a2", "a", deps=(1,))],
    "in_chain_inversion": lambda m: [
        _chain(m, 2, 1, "a2", "a", deps=(1,)), _chain(m, 1, 2, "a1", "a")],
    "scrubbed_deps": lambda m: [
        _chain(m, 2, 1, "a2", "a"), _chain(m, 1, 2, "a1", "a")],
    "late_barrier": lambda m: [
        _chain(m, 1, 1, "a1", "a"), _chain(m, 3, 2, "a2", "a", deps=(1, 2)),
        _rec(m, 2, 3, "bar")],
    "duplicate_seq": lambda m: [
        _chain(m, 1, 1, "a1", "a"), _chain(m, 1, 2, "dup", "b")],
    "forged_resource_set": lambda m: [
        _rec(m, 1, 1, "fft", barrier=False, chain="route:x",
             writes=("route:x",), meta={"plan": _StubPlan()})],
    "honest_resource_set": lambda m: [
        _rec(m, 1, 1, "fft", barrier=False, chain="plan:feedc0de",
             writes=("plan:feedc0de",), meta={"plan": _StubPlan()})],
    "reads_share_a_chain": lambda m: [
        _rec(m, 1, 1, "w", barrier=False, chain="x", writes=("x",)),
        _rec(m, 3, 2, "r2", barrier=False, chain="x", reads=("x",)),
        _rec(m, 2, 3, "r1", barrier=False, chain="x", reads=("x",)),
        _rec(m, 4, 4, "w2", barrier=False, chain="x", writes=("x",))],
    "write_after_read_inverted": lambda m: [
        _rec(m, 1, 1, "r", barrier=False, chain="x", reads=("x",)),
        _rec(m, 3, 2, "w2", barrier=False, chain="x", writes=("x",)),
        _rec(m, 2, 3, "r2", barrier=False, chain="x", reads=("x",))],
}


def _verdict(name, pkg):
    mod, ver = PKGS[pkg]
    try:
        return ("ok", ver.verify_dispatch_log(LOGS[name](mod), source="t",
                                              verify_traces=False))
    except Exception as e:   # compared across packages below
        return (type(e).__name__, {k: getattr(e, k, None) for k in (
            "position", "label", "expected_seq", "observed_seq", "chain",
            "dep_seq", "op")})


@pytest.mark.parametrize("name", sorted(LOGS))
def test_forged_log_verdicts_match_jax(name):
    mine, theirs = _verdict(name, "torch"), _verdict(name, "jax")
    assert mine == theirs
    expect_ok = name in ("total_order", "cross_chain_reorder",
                         "honest_resource_set", "reads_share_a_chain")
    assert (mine[0] == "ok") == expect_ok, mine


# -- scripted submissions ------------------------------------------------------------


def _sleep(s):
    return lambda: time.sleep(s)


def _gated(mod, name, gate, **kw):
    """An engine whose consumer is held by a barrier until ``gate`` is
    set, so every submission of a script is queued before the first pick
    and the pick order is the scheduler's alone, not thread start-up's."""
    e = mod.Engine(name, **kw)
    e.submit(lambda: gate.wait(30), label="gate")
    return e


def _noop():
    return None


def _ooo(mod, gate):
    e = _gated(mod, "dag-ooo", gate, workers=2)
    fs = [e.submit(_sleep(0.15), label="a1", writes=("a",)),
          e.submit(_noop, label="a2", writes=("a",)),
          e.submit(_noop, label="b", writes=("b",), lane=1)]
    return e, fs


def _lanes(mod, gate):
    e = _gated(mod, "dag-lane", gate, workers=2, starve_s=30.0)
    fs = [e.submit(_sleep(0.25), label="plug")]
    fs += [e.submit(_noop, label=f"w{i}", writes=("plan:whale",))
           for i in range(3)]
    fs.append(e.submit(_noop, label="m", writes=("plan:m",), lane=1))
    return e, fs


def _starve(mod, gate):
    e = _gated(mod, "dag-starve", gate, workers=2, starve_s=0.0)
    fs = [e.submit(_sleep(0.2), label="plug"),
          e.submit(_noop, label="lo", writes=("x",)),
          e.submit(_noop, label="hi", writes=("y",), lane=5)]
    return e, fs


def _after(mod, gate):
    e = _gated(mod, "dag-after", gate, workers=2)
    fa = e.submit(_sleep(0.1), label="a", writes=("a",))
    fb = e.submit(_noop, label="b", writes=("b",), lane=1, after=[fa])
    return e, [fa, fb]


def _dag_off(mod, gate):
    e = _gated(mod, "dag-off", gate, workers=2, dag=False)
    fs = [e.submit(_noop, label=f"t{i}", writes=("a" if i % 2 else "b",),
                   lane=i % 3) for i in range(6)]
    return e, fs


def _reads(mod, gate):
    e = _gated(mod, "dag-reads", gate, workers=2)
    fs = [e.submit(_sleep(0.1), label="w", writes=("x",)),
          e.submit(_noop, label="r1", reads=("x",)),
          e.submit(_noop, label="r2", reads=("x",), lane=2),
          e.submit(_noop, label="w2", writes=("x",), lane=3),
          e.submit(_noop, label="y", writes=("y",), lane=1)]
    return e, fs


def _bad_pack(mod, gate):
    e = _gated(mod, "dag-pack", gate, workers=2)
    fs = [e.submit(_sleep(0.1), label="a1", writes=("a",)),
          e.submit(lambda x: x, pack=lambda: 1 / 0, label="a2",
                   writes=("a",)),
          e.submit(_noop, label="a3", writes=("a",)),
          e.submit(_noop, label="bar")]
    return e, fs


def _reform(mod, gate):
    e = _gated(mod, "dag-reform", gate, workers=2)
    fs = [e.submit(_sleep(0.3), label="plug")]
    fs += [e.submit(_noop, label=f"h{i}", writes=("a",), lane=i % 2)
           for i in range(4)]
    gate.set()
    time.sleep(0.05)
    e.reform()
    fs.append(e.submit(lambda: 7, label="fresh", writes=("a",)))
    return e, fs


SCRIPTS = {"out_of_order": _ooo, "lanes": _lanes, "starvation": _starve,
           "after_edges": _after, "dag_off": _dag_off,
           "readers": _reads, "failed_pack": _bad_pack, "reform": _reform}


def _run(script, pkg):
    mod, ver = PKGS[pkg]
    gate = threading.Event()
    e, fs = SCRIPTS[script](mod, gate)
    gate.set()
    try:
        outcomes = []
        for f in fs:
            try:
                f.result(30)
                outcomes.append("ok")
            except Exception as err:   # compared across packages below
                outcomes.append(type(err).__name__)
        assert e.drain(30)
        log = [(r.label, r.outcome, r.chain, r.barrier, r.reads, r.writes,
                r.lane) for r in e.dispatch_log()]
        cert = ver.verify_dispatch_log(e.dispatch_log(), source=script,
                                       verify_traces=False)
        st = e.stats()
        return {"log": log, "outcomes": outcomes,
                "mode": cert["mode"], "chains": cert["chains"],
                "reordered": cert["reordered"],
                "out_of_order": st["out_of_order"] > 0,
                "starved": st["starved_issues"] > 0}
    finally:
        e.close()


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_scripted_dispatch_logs_match_jax(script):
    mine = _run(script, "torch")
    assert mine == _run(script, "jax")
    labels = [r[0] for r in mine["log"]]
    if script == "out_of_order":
        assert labels.index("b") < labels.index("a2")
    if script == "lanes":
        assert labels == ["gate", "plug", "m", "w0", "w1", "w2"]
    if script == "starvation":
        assert labels == ["gate", "plug", "lo", "hi"] and mine["starved"]
    if script == "dag_off":
        assert labels == ["gate"] + [f"t{i}" for i in range(6)]
        assert mine["mode"] == "total" and not mine["out_of_order"]
    if script == "reform":
        assert mine["outcomes"] == ["ok"] + ["EngineReformedError"] * 4 + [
            "ok"]
        assert labels == ["fresh"]


def test_after_refuses_cross_engine_edges():
    e1 = engine.Engine("dag-x1", workers=2)
    e2 = engine.Engine("dag-x2", workers=2)
    try:
        f1 = e1.submit(_noop, label="t1", writes=("a",))
        with pytest.raises(ValueError, match="cross-engine"):
            e2.submit(_noop, label="t2", writes=("b",), after=[f1])
        f1.result(30)
    finally:
        e1.close()
        e2.close()


def test_resource_tokens_must_be_strings():
    e = engine.Engine("dag-tok")
    try:
        with pytest.raises(TypeError, match="str"):
            e.submit(_noop, writes=(1,))
    finally:
        e.close()


def test_dag_env_escape_hatch(monkeypatch):
    monkeypatch.setenv(eng_config.ENGINE_DAG_VAR, "0")
    e = engine.Engine("dag-env")
    try:
        assert not e.dag
        e.submit(_noop, writes=("a",)).result(10)
        assert all(r.barrier for r in e.dispatch_log())
    finally:
        e.close()


def test_lane_gauges_emitted(tmp_path, monkeypatch):
    from pencilarrays_tpu_torch import obs

    monkeypatch.setenv(obs.ENV_VAR, str(tmp_path / "obs"))
    obs_events._reset_for_tests()
    e = engine.Engine("dag-gauge", workers=2)
    try:
        fa = e.submit(_noop, label="a", writes=("a",))
        fb = e.submit(_noop, label="b", writes=("b",), lane=2)
        fa.result(30)
        fb.result(30)
        assert e.drain(30)
        gauges = obs.snapshot()["gauges"]
        assert any(k.startswith("engine.lanes{") and "lane=2" in k
                   for k in gauges), gauges
        assert any(k.startswith("engine.ready_tasks{") for k in gauges)
    finally:
        e.close()
