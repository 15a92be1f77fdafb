"""The port's fleet chaos drills across real OS processes (the JAX
package's ``tests/test_fleet_chaos.py`` and the router-SIGKILL drill of
``tests/test_partition_chaos.py``, ported).

Mesh processes run ``tests/torch_fleet_worker.py`` (one port
``PlanService`` on a one-rank CPU topology each), the router runs in
this process — or, in the WAL drill, in ``tests/torch_router_worker.py``
— joined only through a shared ``FileKV`` directory, with the JAX
drills' fault specs, sizes and assertions.  Each drill carries its own
time limit (``_limit``: SIGALRM raises in the test), so a hang fails the
drill instead of stalling the suite.  The three-mesh double failover is
``slow`` in both packages: it adds a third worker process and a second
lease expiry (about 2 TTLs) to the whole-mesh drill, which the default
run already covers.
"""

import contextlib
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from pencilarrays_tpu_torch import obs
from pencilarrays_tpu_torch.cluster.kv import FileKV
from pencilarrays_tpu_torch.fleet import FleetRouter, MeshBoard
from pencilarrays_tpu_torch.fleet import wal as walmod
from pencilarrays_tpu_torch.obs import events as obs_events
from pencilarrays_tpu_torch.obs import metrics as obs_metrics
from pencilarrays_tpu_torch.resilience import faults

TTL = 2.0
BOOT_S = 60.0       # torch import + plan build on a cold worker
SHAPES = {"minnow": (8, 6, 4), "whale": (16, 12, 8)}
HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(autouse=True)
def _clean():
    faults.clear()
    obs_events._reset_for_tests()
    obs_metrics.registry.reset()
    yield
    faults.clear()
    obs_events._reset_for_tests()
    obs_metrics.registry.reset()


@contextlib.contextmanager
def _limit(seconds):
    """Fail the drill with TimeoutError after ``seconds``."""
    def fire(signum, frame):
        raise TimeoutError(f"drill exceeded its {seconds} s limit")

    old = signal.signal(signal.SIGALRM, fire)
    signal.alarm(int(seconds))
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def _env(fault="", delay_s=None, **extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PENCILARRAYS_TPU_")}
    env.update({"PYTHONPATH": os.path.dirname(HERE),
                "PA_FLEET_TEST_TTL": str(TTL),
                "PENCILARRAYS_TPU_FAULTS": fault, **extra})
    if delay_s is not None:
        env["PENCILARRAYS_TPU_FAULTS_DELAY_S"] = str(delay_s)
    return env


def _spawn(kvroot, mesh, tmpdir, *, fault="", delay_s=None, max_s=120):
    return subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_fleet_worker.py"),
         kvroot, str(mesh), tmpdir, str(max_s)],
        env=_env(fault, delay_s), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def _await_live(kv, meshes):
    board = MeshBoard(kv, ttl=TTL)
    deadline = time.monotonic() + BOOT_S
    while time.monotonic() < deadline:
        if board.live_meshes(meshes) == sorted(meshes):
            return
        time.sleep(0.1)
    raise AssertionError(f"meshes {meshes} never all came alive")


def _reap(procs, timeout=30):
    outs = {}
    for mesh, p in procs.items():
        try:
            outs[mesh], _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            outs[mesh], _ = p.communicate()
    return outs


def _stop_all(kv, procs):
    for m in procs:
        kv.set(f"pa/fleet/stop/m{m}", "stop")
    for p in procs.values():
        if p.poll() is None:
            try:
                p.wait(timeout=15)
            except subprocess.TimeoutExpired:
                p.kill()


def _host(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def test_whole_mesh_loss_mid_storm(tmp_path):
    """Two port mesh processes, a mixed storm, mesh 1 SIGKILLed by its
    own 4th routed request (``fleet.route:kill%mesh1@4`` in both
    workers' environments): typed detection by lease expiry, rebind to
    mesh 2, every ticket resolved exactly once and correct, and the
    merged journal rendering lint-clean through the port's ``pa-obs``
    with one rebound request reconstructed across processes."""
    kvroot = str(tmp_path / "kv")
    obsdir = str(tmp_path / "obs")
    kv = FileKV(kvroot)
    procs = {}
    router = None
    with _limit(180):
        try:
            procs = {m: _spawn(kvroot, m, str(tmp_path),
                               fault="fleet.route:kill%mesh1@4")
                     for m in (1, 2)}
            _await_live(kv, [1, 2])
            obs.enable(obsdir)
            router = FleetRouter(kv, ttl=TTL)
            router.register_mesh(1)
            router.register_mesh(2)
            tickets = []
            for i in range(12):
                tenant = "whale" if i % 3 == 0 else "minnow"
                u = _host(i, SHAPES[tenant])
                tickets.append((router.submit(tenant, u, name=tenant), u))
            deadline = time.monotonic() + 60.0
            while time.monotonic() < deadline:
                router.pump()
                if router.stats()["dead_meshes"]:
                    break
                time.sleep(0.05)
            assert router.stats()["dead_meshes"] == [1]
            assert procs[1].wait(timeout=30) == -signal.SIGKILL
            for i in range(12, 16):
                tenant = "whale" if i % 3 == 0 else "minnow"
                u = _host(i, SHAPES[tenant])
                tickets.append((router.submit(tenant, u, name=tenant), u))
            assert router.drain(60.0) == 0
            stats = router.stats()
            assert stats["completed"] == len(tickets)
            assert stats["failed"] == 0 and stats["duplicates"] == 0
            for t, u in tickets:
                np.testing.assert_allclose(np.asarray(t.result(1.0)),
                                           np.fft.fftn(u),
                                           rtol=1e-3, atol=1e-3)
        finally:
            if router is not None:
                router.close()
            obs.disable()
            _stop_all(kv, procs)
            outs = _reap(procs)

    assert "EXITED mesh=2" in outs[2], outs[2]
    events = obs_events.read_journal(obsdir)
    fo = [e for e in events if e["ev"] == "fleet.failover"]
    assert len(fo) == 1 and fo[0]["mesh"] == 1
    assert fo[0]["tickets"] >= 1
    assert fo[0]["error"] == "MeshFailureError"
    assert TTL <= fo[0]["detect_s"] < 20.0
    expired = [e for e in events if e["ev"] == "fleet.lease"
               and e.get("status") == "expired"]
    assert any(e["mesh"] == 1 for e in expired)
    reasons = [e["reason"] for e in events if e["ev"] == "fleet.route"]
    assert reasons.count("rebind") >= 1
    killed = [e for e in events if e["ev"] == "fault"
              and e.get("point") == "fleet.route"]
    assert any(e.get("mode") == "kill" for e in killed)

    from pencilarrays_tpu_torch.obs.__main__ import main
    from pencilarrays_tpu_torch.obs.requestflow import reconstruct_request

    assert main(["lint", obsdir]) == 0
    assert main(["timeline", obsdir]) == 0
    assert main(["trace", obsdir, "-o", str(tmp_path / "trace.json")]) == 0
    rebind_traces = sorted({e["trace"] for e in events
                            if e["ev"] == "fleet.route"
                            and e["reason"] == "rebind"})
    assert rebind_traces, "no rebind carried a trace id"
    rt, _warnings = reconstruct_request(obsdir, rebind_traces[0])
    assert rt is not None and rt.trace == rebind_traces[0]
    assert len(rt.ranks) >= 2, rt.ranks
    assert rt.rebinds >= 1 and rt.outcome == "ok"
    evs = [e["ev"] for e in rt.events]
    assert "fleet.route" in evs and "fleet.failover" in evs
    assert "serve.complete" in evs
    assert (evs.index("fleet.failover")
            < max(i for i, e in enumerate(evs) if e == "serve.complete"))
    assert main(["request", obsdir, rebind_traces[0]]) == 0
    assert main(["requests", obsdir]) == 0
    assert main(["request", obsdir, "feedfacedeadbeef"]) == 1


def test_router_sigkill_mid_storm_wal_replay(tmp_path):
    """The port's router process is SIGKILLed at its 7th admission
    (``fleet.route:kill@7``); a fresh router over the same WAL directory
    replays the log and every one of the 6 committed admissions
    resolves exactly once, correct."""
    kvroot = str(tmp_path / "kv")
    waldir = str(tmp_path / "wal")
    obsdir = str(tmp_path / "obs")
    kv = FileKV(kvroot)
    worker = None
    router = None
    with _limit(180):
        try:
            # the mesh is dragged 0.3 s per routed take, so most of the
            # storm is still unexecuted when the router dies
            worker = _spawn(kvroot, 1, str(tmp_path),
                            fault="fleet.route:delay%mesh1", delay_s=0.3,
                            max_s=150)
            _await_live(kv, [1])
            rproc = subprocess.Popen(
                [sys.executable, os.path.join(HERE, "torch_router_worker.py"),
                 kvroot, waldir, "10", "1"],
                env=_env("fleet.route:kill@7", PENCILARRAYS_TPU_OBS=obsdir,
                         PENCILARRAYS_TPU_CLUSTER_RANK="3"),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            rout, _ = rproc.communicate(timeout=120)
            assert rproc.returncode == -signal.SIGKILL, (rproc.returncode,
                                                         rout[-2000:])
            assert "ROUTER_READY" in rout and "ROUTER_DRAINED" not in rout
            obs.enable(obsdir)
            router = FleetRouter(kv, ttl=TTL, wal_dir=waldir)
            router.register_mesh(1)
            rep = router.recover()
            assert rep["outcome"] == "clean" and rep["skipped"] == 0, rep
            assert rep["resolved"] + rep["reparked"] == 6, rep
            assert rep["reparked"] >= 1, rep
            with router._lock:
                held = [(p.ticket, np.asarray(p.payload))
                        for p in router._pending.values()]
            assert len(held) == rep["reparked"]
            assert router.drain(90.0) == 0
            for t, u in held:
                np.testing.assert_allclose(np.asarray(t.result(1.0)),
                                           np.fft.fftn(u),
                                           rtol=1e-3, atol=1e-3)
            stats = router.stats()
            assert stats["completed"] == rep["reparked"]
            assert stats["failed"] == 0 and stats["duplicates"] == 0
            assert stats["pending"] == 0
            rep2 = router.recover()
            assert rep2["reparked"] == 0 and rep2["resolved"] == 6, rep2
            records, skipped = walmod.read_wal(waldir)
            assert skipped == 0
            fold = walmod.replay(records)
            assert fold["pending"] == {} and fold["duplicates"] == 0
            assert len(fold["resolved"]) == 6
            completes = [r for r in records if r["op"] == "complete"]
            assert len(completes) == 6
            assert all(r["outcome"] == "ok" for r in completes)
        finally:
            if router is not None:
                router.close()
            obs.disable()
            if worker is not None:
                _stop_all(kv, {1: worker})
                wout = _reap({1: worker})[1]

    assert "EXITED mesh=1" in wout, wout[-2000:]
    events = obs_events.read_journal(obsdir)
    wal_evs = [e for e in events if e["ev"] == "fleet.wal"]
    assert any(e["outcome"] == "clean" and e["resolved"]
               + e["reparked"] == 6 for e in wal_evs), wal_evs
    snap = obs_metrics.registry.snapshot()["counters"]
    assert snap.get("fleet.wal_replays{outcome=clean}", 0) >= 1
    killed = [e for e in events if e["ev"] == "fault"
              and e.get("point") == "fleet.route"]
    assert any(e.get("mode") == "kill" for e in killed)

    from pencilarrays_tpu_torch.obs.__main__ import main

    assert main(["lint", obsdir]) == 0
    assert main(["timeline", obsdir]) == 0


@pytest.mark.slow
def test_double_failover_across_processes(tmp_path):
    """Three port mesh processes; the placed mesh is SIGKILLed, then
    the re-bind target too — the ticket resolves exactly once on the
    third."""
    kvroot = str(tmp_path / "kv")
    kv = FileKV(kvroot)
    procs = {}
    router = None
    with _limit(240):
        try:
            procs = {m: _spawn(kvroot, m, str(tmp_path)) for m in (1, 2, 3)}
            _await_live(kv, [1, 2, 3])
            router = FleetRouter(kv, ttl=TTL)
            for m in procs:
                router.register_mesh(m)
            u = _host(99, SHAPES["minnow"])
            first = router._place("minnow", u.nbytes, None)[0]
            procs[first].send_signal(signal.SIGKILL)
            procs[first].wait(timeout=15)
            t = router.submit("acme", u, name="minnow")
            with router._lock:
                placed = next(iter(router._pending.values())).mesh
            if placed == first:
                deadline = time.monotonic() + 30.0
                while time.monotonic() < deadline:
                    router.pump()
                    if router.stats()["dead_meshes"]:
                        break
                    time.sleep(0.05)
                with router._lock:
                    pend = next(iter(router._pending.values()), None)
                placed = pend.mesh if pend is not None else None
            if placed is not None:
                procs[placed].send_signal(signal.SIGKILL)
                procs[placed].wait(timeout=15)
            assert router.drain(60.0) == 0
            np.testing.assert_allclose(np.asarray(t.result(1.0)),
                                       np.fft.fftn(u), rtol=1e-3, atol=1e-3)
            stats = router.stats()
            assert stats["completed"] == 1 and stats["failed"] == 0
            assert stats["duplicates"] == 0
            assert len(stats["dead_meshes"]) >= 1
        finally:
            if router is not None:
                router.close()
            _stop_all(kv, procs)
            _reap(procs)
