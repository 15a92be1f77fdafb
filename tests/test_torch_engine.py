"""PyTorch port vs JAX package: the task-graph executor (``engine/``).

The cases of ``tests/test_engine.py`` that need no ``serve/``, ``guard/``
or ``cluster.elastic``, on the port's ``Engine``: typed errors and
failure scoping, pack overlap, host tasks and timers, ``RuntimeConfig``
resolution (field for field equal to the JAX package's on the same
environment) and the frozen snapshot, stale generations, quiesce,
reform, the ``spawn_thread`` inventory and ``run_steps_async`` failure
propagation; plus the request trace the consumer installs for each
dispatch.  Host timings here are sleeps of tens of milliseconds, the
JAX tests' own.
"""

import dataclasses
import threading
import time

import pytest

from pencilarrays_tpu.analysis import spmd as jax_spmd
from pencilarrays_tpu.analysis.errors import (
    DispatchOrderError as JaxDispatchOrderError,
)
from pencilarrays_tpu.engine import DispatchRecord as JaxRecord
from pencilarrays_tpu.engine import config as jax_config
from pencilarrays_tpu_torch import cluster, obs
from pencilarrays_tpu_torch.analysis import spmd
from pencilarrays_tpu_torch.analysis.errors import DispatchOrderError
from pencilarrays_tpu_torch.engine import (
    DispatchRecord,
    Engine,
    EngineClosedError,
    EngineReformedError,
    EngineTaskError,
    RuntimeConfig,
    run_steps_async,
)
from pencilarrays_tpu_torch.engine import config as eng_config
from pencilarrays_tpu_torch.obs import events as obs_events


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in eng_config.WATCHED_VARS:
        monkeypatch.delenv(var, raising=False)
    obs_events._reset_for_tests()
    yield
    obs_events._reset_for_tests()


# -- ordering and failure scoping --------------------------------------------


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_dispatch_order_error_is_typed_and_names_position(pkg):
    Rec, verify, Err = ((DispatchRecord, spmd.verify_dispatch_log,
                         DispatchOrderError) if pkg == "torch" else
                        (JaxRecord, jax_spmd.verify_dispatch_log,
                         JaxDispatchOrderError))
    rec = [Rec(enqueue_seq=1, issue_seq=1, label="a", outcome="ok",
               queued_s=0, run_s=0),
           Rec(enqueue_seq=3, issue_seq=2, label="b", outcome="ok",
               queued_s=0, run_s=0),
           Rec(enqueue_seq=2, issue_seq=3, label="c", outcome="ok",
               queued_s=0, run_s=0)]
    with pytest.raises(Err) as ei:
        verify(rec, source="drill")
    assert (ei.value.position, ei.value.label, ei.value.observed_seq) == (
        2, "c", 2)
    # gaps (interleaved traffic of other clients) are not inversions
    ok = verify([rec[0], Rec(enqueue_seq=7, issue_seq=2, label="g",
                             outcome="ok", queued_s=0, run_s=0)],
                source="drill")
    assert ok["order_ok"]


def test_worker_pool_exception_typed_and_queue_drains():
    engine = Engine("errs", workers=2)
    before = engine.submit(lambda: "a", label="before")
    bad = engine.submit(lambda x: x, pack=lambda: 1 / 0, label="bad")
    after = [engine.submit(lambda i=i: i, label=f"after{i}")
             for i in range(5)]
    assert before.result(10) == "a"
    assert [f.result(10) for f in after] == list(range(5))
    with pytest.raises(EngineTaskError) as ei:
        bad.result(10)
    assert isinstance(ei.value.cause, ZeroDivisionError)
    assert ei.value.stage == "pack"
    assert isinstance(ei.value.__cause__, ZeroDivisionError)
    log = engine.dispatch_log()
    assert [r.label for r in log][:2] == ["before", "bad"]
    assert log[1].outcome == "EngineTaskError"
    engine.close()


def test_dispatch_error_fails_only_its_future():
    engine = Engine("scope", workers=1)
    bad = engine.submit(lambda: 1 / 0, label="bad-run")
    good = engine.submit(lambda: "fine", label="good")
    assert good.result(10) == "fine"
    with pytest.raises(ZeroDivisionError):
        bad.result(10)
    engine.close()


def test_closed_engine_rejects_typed():
    engine = Engine("closed")
    engine.close()
    with pytest.raises(EngineClosedError):
        engine.submit(lambda: 1)
    with pytest.raises(EngineClosedError):
        engine.host_task(lambda: 1)
    with pytest.raises(EngineClosedError):
        engine.call_later(0.0, lambda: None)


# -- host overlap ---------------------------------------------------------------


def test_pack_overlaps_previous_dispatch():
    """With pack ~= run, a K-step chain approaches pack + K*run instead of
    K*(pack + run)."""
    engine = Engine("overlap", workers=2)
    d = 0.08
    t0 = time.perf_counter()
    futs = [engine.submit(lambda _: time.sleep(d),
                          pack=lambda: time.sleep(d),
                          label=f"s{i}") for i in range(4)]
    for f in futs:
        f.result(30)
    wall = time.perf_counter() - t0
    assert wall < 4 * 2 * d * 0.85, wall
    st = engine.stats()
    assert st["dispatched"] == 4 and st["host_tasks"] == 4
    engine.close()


def test_host_task_and_timers():
    engine = Engine("host")
    assert engine.host_task(lambda: 41).result(10) == 41
    hits = []
    engine.call_later(0.02, lambda: hits.append(1))
    deadline = time.monotonic() + 5
    while not hits and time.monotonic() < deadline:
        time.sleep(0.01)
    assert hits == [1]
    with pytest.raises(EngineTaskError) as ei:
        engine.host_task(lambda: [][1], label="oops").result(10)
    assert ei.value.stage == "host" and ei.value.label == "oops"
    engine.close()


def test_idle_host_worker_keeps_nothing_alive():
    """A host worker waiting for its next item holds nothing of its last
    one: the item's closure (a served batch's tickets, and with them
    their results on the card) goes once the item ran."""
    import gc
    import weakref

    class Held:
        pass

    engine = Engine("host-idle")
    held = Held()
    ref = weakref.ref(held)
    assert engine.host_task(lambda h=held: 1).result(10) == 1
    assert engine.submit(lambda x: x, pack=lambda h=held: 2).result(10) == 2
    del held
    deadline = time.monotonic() + 5
    while ref() is not None and time.monotonic() < deadline:
        gc.collect()
        time.sleep(0.01)
    assert ref() is None
    engine.close()


# -- RuntimeConfig ----------------------------------------------------------------


def test_watched_vars_match_jax():
    assert eng_config.WATCHED_VARS == jax_config.WATCHED_VARS
    assert [f.name for f in dataclasses.fields(RuntimeConfig)] == [
        f.name for f in dataclasses.fields(jax_config.RuntimeConfig)]


@pytest.mark.parametrize("env", [
    {},
    {"PENCILARRAYS_TPU_GUARD_TIMEOUT": "12.5",
     "PENCILARRAYS_TPU_CLUSTER_LEASE_TTL": "3.5",
     "PENCILARRAYS_TPU_ELASTIC_ROUNDS": "4",
     "PENCILARRAYS_TPU_OBS_AGG_S": "2.5",
     "PENCILARRAYS_TPU_ENGINE_WORKERS": "3"},
    {"PENCILARRAYS_TPU_GUARD_TIMEOUT": "nan-ish",
     "PENCILARRAYS_TPU_ELASTIC_ROUNDS": "zero",
     "PENCILARRAYS_TPU_ENGINE_WORKERS": "0",
     "PENCILARRAYS_TPU_ENGINE_STARVE_S": "-2"},
    {"PENCILARRAYS_TPU_OBS": "OFF", "PENCILARRAYS_TPU_CLUSTER": "OFF",
     "PENCILARRAYS_TPU_ENGINE_DAG": "Off", "PENCILARRAYS_TPU_OBS_MAX_MB": "1.5",
     "PENCILARRAYS_TPU_ELASTIC_QUORUM": "false",
     "PENCILARRAYS_TPU_CLUSTER_RANK": "5"},
], ids=["defaults", "set", "malformed", "gates"])
def test_runtime_config_resolves_as_jax(env):
    """One environment arms both packages alike: every field equal."""
    assert dataclasses.asdict(RuntimeConfig.resolve(env)) == \
        dataclasses.asdict(jax_config.RuntimeConfig.resolve(env))


def test_runtime_config_resolves_every_layer(monkeypatch):
    monkeypatch.setenv("PENCILARRAYS_TPU_GUARD_TIMEOUT", "12.5")
    monkeypatch.setenv("PENCILARRAYS_TPU_ELASTIC_ROUNDS", "4")
    monkeypatch.setenv(eng_config.ENGINE_WORKERS_VAR, "3")
    cfg = RuntimeConfig.resolve()
    assert (cfg.guard_timeout, cfg.elastic_rounds, cfg.engine_workers) == (
        12.5, 4, 3)
    monkeypatch.setenv("PENCILARRAYS_TPU_GUARD_TIMEOUT", "nan-ish")
    monkeypatch.setenv("PENCILARRAYS_TPU_ELASTIC_ROUNDS", "zero")
    cfg = RuntimeConfig.resolve()
    assert (cfg.guard_timeout, cfg.elastic_rounds) == (300.0, 8)


def test_layer_accessors_delegate_and_late_arm(monkeypatch, tmp_path):
    monkeypatch.setenv("PENCILARRAYS_TPU_CLUSTER_RANK", "5")
    assert cluster.rank() == 5
    monkeypatch.setenv("PENCILARRAYS_TPU_CLUSTER_RANK", "6")
    assert cluster.rank() == 6
    monkeypatch.setenv("PENCILARRAYS_TPU_CLUSTER_WORLD", "7")
    assert cluster.world_size() == 7
    monkeypatch.delenv("PENCILARRAYS_TPU_CLUSTER_RANK")
    monkeypatch.delenv("PENCILARRAYS_TPU_CLUSTER_WORLD")
    assert (cluster.rank(), cluster.world_size()) == (0, 1)
    assert not obs.enabled()
    monkeypatch.setenv(obs.ENV_VAR, str(tmp_path))
    assert obs.enabled() and obs.journal_dir() == str(tmp_path)
    monkeypatch.delenv(obs.ENV_VAR)
    assert not obs.enabled()
    # the JAX package's contract: no coordinator when the layer is off
    # or the world is one rank (the local recovery ladder)
    assert cluster.coordinator() is None
    monkeypatch.setenv(cluster.ENV_VAR, "1")
    assert cluster.coordinator() is None


def test_env_key_fast_path_sees_every_mutation(monkeypatch):
    for var in eng_config.WATCHED_VARS:
        monkeypatch.delenv(var, raising=False)
        before = eng_config._env_key()
        monkeypatch.setenv(var, "_pin_a")
        a = eng_config._env_key()
        assert a != before, f"{var}: set invisible to the fast path"
        monkeypatch.setenv(var, "_pin_b")
        assert eng_config._env_key() != a, f"{var}: change invisible"
        monkeypatch.delenv(var)
        assert eng_config._env_key() == before, f"{var}: delete invisible"
    monkeypatch.setenv("PENCILARRAYS_TPU_OBS", "1")
    assert eng_config.current().obs_on
    monkeypatch.delenv("PENCILARRAYS_TPU_OBS")
    assert not eng_config.current().obs_on


def test_engine_snapshot_frozen_at_construction(monkeypatch):
    monkeypatch.setenv("PENCILARRAYS_TPU_GUARD_TIMEOUT", "11")
    engine = Engine("frozen")
    assert engine.config.guard_timeout == 11.0
    monkeypatch.setenv("PENCILARRAYS_TPU_GUARD_TIMEOUT", "22")
    assert eng_config.current().guard_timeout == 22.0
    assert engine.config.guard_timeout == 11.0
    engine.reform()
    assert engine.config.guard_timeout == 22.0
    assert engine.generation == 1
    engine.close()


def test_zero_workers_refused():
    with pytest.raises(ValueError, match="workers"):
        Engine("none", workers=0)


# -- reform, quiesce, stale generations ------------------------------------------


def test_stale_generation_dispatch_skips_log():
    engine = Engine("stale", workers=1)
    started, release = threading.Event(), threading.Event()

    def slow():
        started.set()
        release.wait(30)
        return "slow"

    f_old = engine.submit(slow, label="old-gen")
    assert started.wait(10)
    engine.reform(timeout=0.05)
    f_new = engine.submit(lambda: "new", label="new-gen")
    assert f_new.result(10) == "new"
    release.set()
    assert f_old.result(10) == "slow"
    assert [r.label for r in engine.dispatch_log()] == ["new-gen"]
    assert spmd.verify_dispatch_log(engine.dispatch_log(),
                                    source="stale")["order_ok"]
    assert not engine.stats()["busy"]
    engine.close()


def test_quiesce_waits_for_mid_flight_timer():
    engine = Engine("timerbusy")
    started, release = threading.Event(), threading.Event()

    def tick():
        started.set()
        release.wait(10)

    engine.call_later(0.0, tick)
    assert started.wait(10)
    assert not engine.quiesce(0.2)
    release.set()
    assert engine.quiesce(10)
    engine.resume()
    engine.close()


def test_quiesce_from_the_consumer_does_not_wait_for_itself():
    engine = Engine("selfq")
    out = engine.submit(lambda: (engine.on_consumer_thread(),
                                 engine.quiesce(5))).result(10)
    assert out == (True, True)
    assert not engine.on_consumer_thread()
    engine.resume()
    assert engine.submit(lambda: 2).result(10) == 2
    engine.close()


def test_dispatch_log_meta_is_a_snapshot():
    engine = Engine("snap")
    meta = {"k": 1}
    engine.submit(lambda: None, label="m", meta=meta).result(10)
    meta["k"] = 2
    rec = engine.dispatch_log()[-1]
    assert rec.meta == {"k": 1} and rec.meta is not meta
    engine.close()


def test_reform_fails_held_dispatches_typed():
    engine = Engine("held")
    assert engine.quiesce(5)
    held = engine.submit(lambda: "never", label="held")
    hooked = []
    engine.on_reform(lambda e: hooked.append(e.generation))
    engine.reform()
    with pytest.raises(EngineReformedError) as ei:
        held.result(10)
    assert ei.value.generation == 1 and hooked == [1]
    assert engine.submit(lambda: "alive").result(10) == "alive"
    engine.close()


def test_spawn_thread_inventory():
    from pencilarrays_tpu_torch.engine.threads import spawned

    engine = Engine("inv")
    engine.submit(lambda: None).result(10)
    engine.host_task(lambda: None).result(10)
    names = spawned()
    assert any(n.startswith("pa-engine-inv-dispatch") for n in names)
    assert any(n.startswith("pa-engine-inv-host") for n in names)
    engine.close()


# -- the step-loop pipeline ---------------------------------------------------------


def test_run_steps_async_propagates_step_failure():
    calls = {"n": 0}

    class Boom(RuntimeError):
        pass

    def stepper(s):
        calls["n"] += 1
        if calls["n"] == 3:
            raise Boom("step 3 dies")
        return s + 1

    engine = Engine("fail-prop")
    try:
        pipe = run_steps_async(stepper, 0, 5, engine=engine)
        with pytest.raises(Boom):
            pipe.result(60)
        assert calls["n"] == 3
    finally:
        engine.close()


def test_run_steps_async_validates_arguments():
    with pytest.raises(ValueError, match="n_steps"):
        run_steps_async(lambda s: s, 0, 0)
    with pytest.raises(ValueError, match="together"):
        run_steps_async(lambda s: s, 0, 2, checkpoint_every=1)


def test_run_steps_async_counts_in_order():
    engine = Engine("count")
    try:
        pipe = run_steps_async(lambda s: s * 2 + 1, 0, 6, engine=engine,
                               label="lin")
        assert pipe.result(30) == 63
        assert [r.label for r in engine.dispatch_log()] == [
            f"lin:{k}" for k in range(1, 7)]
    finally:
        engine.close()


# -- the request trace --------------------------------------------------------------


def test_dispatch_installs_its_request_trace(tmp_path):
    from pencilarrays_tpu_torch.obs import requestflow

    obs.enable(str(tmp_path))
    engine = Engine("trace")
    try:
        tid = requestflow.mint_trace()
        seen = engine.submit(
            lambda: (requestflow.current_trace(),
                     obs.record_event("retry", label="x", attempt=1,
                                      max_attempts=2, delay_s=0.0,
                                      error="e")),
            meta={"trace": tid}).result(10)
        assert seen[0] == tid
        assert engine.submit(requestflow.current_trace).result(10) is None
        recs = [e for e in obs.read_journal(str(tmp_path))
                if e["ev"] == "retry"]
        assert [e["trace"] for e in recs] == [tid]
        assert obs.lint_journal(str(tmp_path)) == []
    finally:
        engine.close()
        obs.disable()
