"""PyTorch port vs JAX package: the multi-mesh fleet (``fleet/``).

Every case of the JAX package's ``tests/test_fleet.py`` runs as a
scenario through both packages (:func:`run_both`): the same script
against each package's surface (:class:`FPkg`), from a clean state
(faults, journal, metrics and the fleet's environment knobs reset), in
a directory of its own.  What a scenario returns — outcomes, stats, KV
keys, decoded wire values and the ``fleet.*`` journal records without
their clocks and ids — must be equal, and FFT results (each also held
to ``np.fft.fftn`` within the JAX test's 1e-4) within 2e-5 of the
reference's largest magnitude (``tests/test_torch_fft.py``'s
tolerance).  In-process meshes run a one-rank ``PlanService`` each (the
JAX package's on one CPU device, the port's on a one-rank CPU
topology).  The lint cases run the JAX fixture trees through each
package's own linter (the port's under ``pencilarrays_tpu_torch/``).

Beyond the JAX cases: a mixed fleet (a JAX router placing on a port
mesh and a port router on a JAX mesh over one ``FileKV``, with the wire
values byte-identical) and a mesh of two ranks (one ``MeshWorker`` and
``PlanService`` per rank on two gloo ranks, rank 0 speaking for the
mesh) answering a routed storm.
"""

import json
import os
import textwrap
import time

import numpy as np
import pytest

FLEET_ENV = ("PENCILARRAYS_TPU_OBS", "PENCILARRAYS_TPU_FAULTS",
             "PENCILARRAYS_TPU_FLEET_MESH", "PENCILARRAYS_TPU_FLEET_SPAWN",
             "PENCILARRAYS_TPU_FLEET_DCN_LATENCY_BYTES",
             "PENCILARRAYS_TPU_FLEET_DCN_FACTOR",
             "PENCILARRAYS_TPU_FLEET_COMPILE_PENALTY",
             "PENCILARRAYS_TPU_CLUSTER_RANK")

# fields of fleet records that differ run to run or package to package
# for reasons that are not behavior: clocks and measured ages, process
# ids, process-global ticket ids and minted trace ids, the journal's own
# bookkeeping, paths, and the backlog term (each package's own load
# tracker)
VOLATILE = {"t", "ts", "t_wall", "t_mono", "wall", "mono", "pid", "proc",
            "host", "thread", "seq", "run", "run_id", "age_s", "detect_s",
            "ticket", "trace", "traces", "dir", "score_bytes",
            "backlog_bytes", "epoch", "step", "plan"}


class FPkg:
    """The surface of one package the fleet scenarios use."""

    def __init__(self, which: str):
        self.name = which
        if which == "jax":
            import jax

            import pencilarrays_tpu as pa
            from pencilarrays_tpu import fleet, obs
            from pencilarrays_tpu.analysis import lint
            from pencilarrays_tpu.cluster.kv import FileKV
            from pencilarrays_tpu.fleet import errors, wal, wire
            from pencilarrays_tpu.obs import events, metrics
            from pencilarrays_tpu.resilience import faults
            from pencilarrays_tpu.resilience.errors import InjectedFault
            from pencilarrays_tpu.serve import (SLO, AdmissionError,
                                                DeadlineError, PlanService)

            self.topo1 = lambda: pa.Topology((1,), devices=jax.devices()[:1])
            self.package = "pencilarrays_tpu"
        else:
            import pencilarrays_tpu_torch as pa
            from pencilarrays_tpu_torch import fleet, obs
            from pencilarrays_tpu_torch.analysis import lint
            from pencilarrays_tpu_torch.cluster.kv import FileKV
            from pencilarrays_tpu_torch.fleet import errors, wal, wire
            from pencilarrays_tpu_torch.obs import events, metrics
            from pencilarrays_tpu_torch.resilience import faults
            from pencilarrays_tpu_torch.resilience.errors import InjectedFault
            from pencilarrays_tpu_torch.serve import (SLO, AdmissionError,
                                                      DeadlineError,
                                                      PlanService)

            self.topo1 = lambda: pa.Topology((1,), device="cpu")
            self.package = "pencilarrays_tpu_torch"
        self.pa, self.fleet, self.obs, self.lint = pa, fleet, obs, lint
        self.FileKV, self.errors, self.wal, self.wire = FileKV, errors, \
            wal, wire
        self.events, self.metrics = events, metrics
        self.faults, self.InjectedFault = faults, InjectedFault
        self.SLO, self.AdmissionError = SLO, AdmissionError
        self.DeadlineError, self.PlanService = DeadlineError, PlanService
        for name in ("FleetCost", "FleetRouter", "FleetSupervisor",
                     "MeshBoard", "MeshFailureError", "MeshLease",
                     "MeshLeftError", "MeshWorker", "MESH_ENV", "mesh_id"):
            setattr(self, name, getattr(fleet, name))
        self.FleetError = errors.FleetError

    def reset(self) -> None:
        self.faults.clear()
        self.events._reset_for_tests()
        self.metrics.registry.reset()

    def kv(self, d, sub="kv"):
        return self.FileKV(os.path.join(str(d), sub))

    def service(self, shape=(8, 6, 4), name="fft"):
        topo = self.topo1()
        svc = self.PlanService(max_batch=4, max_wait_s=0.0)
        svc.register_plan(name, lambda ctx: self.pa.PencilFFTPlan(
            topo, shape))
        return svc

    def worker(self, kv, mesh, *, ttl=0.3, warm=True, **kw):
        w = self.MeshWorker(kv, mesh, service=self.service(), ttl=ttl, **kw)
        if warm:
            w.prewarm(["fft"])
        return w

    def records(self, d, prefix="fleet."):
        """The journal's ``prefix`` records, stable fields only, in
        journal order."""
        out = []
        for e in self.events.read_journal(str(d)):
            if str(e.get("ev", "")).startswith(prefix):
                out.append({k: v for k, v in e.items()
                            if k not in VOLATILE})
        return out


_PKGS = {}


def pkg(which: str) -> FPkg:
    if which not in _PKGS:
        _PKGS[which] = FPkg(which)
    return _PKGS[which]


def host(seed, shape=(8, 6, 4)):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _canon(v):
    return json.loads(json.dumps(v, sort_keys=True, default=str))


def _fft_close(got, u):
    np.testing.assert_allclose(got, np.fft.fftn(u), rtol=1e-4, atol=1e-4)


def run_both(scenario, tmp_path, monkeypatch):
    """``scenario(P, d, mp)`` through each package from a clean state;
    the port's result must equal JAX's (arrays under ``"fft"`` within
    2e-5 of max|ref|)."""
    got = {}
    for which in ("jax", "torch"):
        P = pkg(which)
        d = tmp_path / which
        d.mkdir()
        with monkeypatch.context() as mp:
            for var in FLEET_ENV:
                mp.delenv(var, raising=False)
            for other in _PKGS.values():
                other.reset()
            try:
                got[which] = dict(scenario(P, d, mp) or {})
            finally:
                P.reset()
                P.obs.disable()
    want, have = got["jax"], got["torch"]
    for name, w in want.pop("fft", {}).items():
        g = have["fft"][name]
        err = np.abs(np.asarray(g) - np.asarray(w)).max() / max(
            np.abs(w).max(), 1e-30)
        assert err <= 2e-5, (name, err)
    have.pop("fft", None)
    assert _canon(have) == _canon(want), (want, have)
    return got


def _scenario_test(name):
    def test(tmp_path, monkeypatch):
        run_both(globals()["s_" + name], tmp_path, monkeypatch)

    test.__name__ = "test_" + name
    return test


# -- the two-tier cost model --------------------------------------------------

def s_cost_model_units(P, d, mp):
    c = P.FleetCost()
    assert c.wire_bytes(nbytes_in=1000, nbytes_out=1000, tier="colo") == 0.0
    assert c.wire_bytes(nbytes_in=1000, nbytes_out=500, tier="dcn") \
        == 2 * c.dcn_latency_bytes + c.dcn_byte_factor * 1500
    assert c.affinity_bytes(warm=True) == 0.0
    assert c.affinity_bytes(warm=False) == float(c.compile_penalty_bytes)
    assert c.backlog_bytes(backlog=100.0, deadline_s=None) == 100.0
    assert c.backlog_bytes(backlog=100.0, deadline_s=1.0) \
        == c.slo_drain_weight * 100.0
    s = c.score(nbytes_in=10, nbytes_out=10, tier="dcn", warm=False,
                backlog=5.0)
    assert s["total"] == s["wire"] + s["affinity"] + s["backlog"]
    return {"score": s, "defaults": [c.dcn_latency_bytes, c.dcn_byte_factor,
                                     c.compile_penalty_bytes,
                                     c.slo_drain_weight]}


def s_cost_from_env(P, d, mp):
    mp.setenv("PENCILARRAYS_TPU_FLEET_DCN_LATENCY_BYTES", "100")
    mp.setenv("PENCILARRAYS_TPU_FLEET_DCN_FACTOR", "2.5")
    mp.setenv("PENCILARRAYS_TPU_FLEET_COMPILE_PENALTY", "77")
    c = P.FleetCost.from_env()
    assert (c.dcn_latency_bytes, c.dcn_byte_factor,
            c.compile_penalty_bytes) == (100, 2.5, 77)
    mp.setenv("PENCILARRAYS_TPU_FLEET_DCN_FACTOR", "fast")
    assert P.FleetCost.from_env().dcn_byte_factor \
        == P.FleetCost().dcn_byte_factor
    return {"cost": [c.dcn_latency_bytes, c.dcn_byte_factor,
                     c.compile_penalty_bytes]}


# -- the KV wire: key layout + codec ------------------------------------------

def s_wire_key_layout(P, d, mp):
    w = P.wire
    k9, k10 = w.beat_key("pa", 1, 9), w.beat_key("pa", 1, 10)
    assert k9 < k10 and k9.startswith("pa/fleet/beat/m1/")
    assert w.ticket_id_of(w.req_key("pa", 2, "abc")) == "abc"
    assert w.ticket_id_of(w.res_key("pa", "abc")) == "abc"
    assert w.req_key("pa", 2, "abc").startswith(w.req_dir("pa", 2) + "/")
    return {"keys": [k9, k10, w.left_key("pa", 3), w.load_key("pa", 3),
                     w.req_key("pa", 2, "abc"), w.res_key("pa", "abc"),
                     w.stop_key("pa", 4)]}


def s_wire_request_roundtrip(P, d, mp):
    payload = host(0)
    raw = P.wire.encode_request(
        "t1", tenant="acme", name="fft", direction="forward",
        payload=payload, t_submit=123.0, deadline_s=1.5, rebinds=2)
    req = P.wire.decode_request(raw)
    assert req["payload"].dtype == payload.dtype
    np.testing.assert_array_equal(req["payload"], payload)
    # the KV value itself: byte for byte the same in both packages
    return {"raw": raw, "fields": {k: v for k, v in req.items()
                                   if k != "payload"}}


def s_wire_result_roundtrips(P, d, mp):
    w = P.wire
    value = host(1)
    raw_ok = w.encode_result("t1", value=value, seconds=0.5, mesh=3)
    meta, got, err = w.decode_result(raw_ok)
    assert err is None and meta["mesh"] == 3
    np.testing.assert_array_equal(got, value)
    e = P.AdmissionError("no", tenant="acme", reason="shed")
    _, _, got_e = w.decode_result(w.encode_result("t2", error=e))
    assert isinstance(got_e, P.AdmissionError)
    assert got_e.tenant == "acme" and got_e.reason == "shed"
    e2 = P.DeadlineError("late", tenant="acme", reason="projected",
                         deadline_s=2.0, projected_s=3.5)
    raw_e2 = w.encode_result("t3", error=e2)
    _, _, got_e2 = w.decode_result(raw_e2)
    assert isinstance(got_e2, P.DeadlineError)
    assert got_e2.deadline_s == 2.0 and got_e2.projected_s == 3.5
    _, _, got_e3 = w.decode_result(w.encode_result(
        "t4", error=ValueError("boom")))
    assert isinstance(got_e3, P.FleetError) and "ValueError" in str(got_e3)
    raw = json.loads(w.encode_result(
        "t5", error=P.AdmissionError("no", tenant="a", reason="shed")))
    raw["error"]["kwargs"] = {}
    _, _, got_e4 = w.decode_result(json.dumps(raw))
    assert isinstance(got_e4, P.FleetError)
    with pytest.raises(ValueError):
        w.encode_result("t6")
    with pytest.raises(ValueError):
        w.encode_result("t7", value=value, error=e)
    return {"raw": [raw_ok, raw_e2],
            "types": [type(x).__name__ for x in (got_e, got_e2, got_e3,
                                                 got_e4)],
            "msg3": str(got_e3)}


# -- the %mesh fault selector -------------------------------------------------

def s_mesh_selector_parse(P, d, mp):
    r, = P.faults.parse("fleet.route:kill%mesh1@4")
    assert r.point == "fleet.route" and r.mode == "kill"
    assert r.mesh == 1 and r.rank is None and r.first == 4
    r2, = P.faults.parse("hop.exchange:error%rank2")
    assert r2.rank == 2 and r2.mesh is None
    return {"rules": [[r.point, r.mode, r.mesh, r.rank, r.first],
                      [r2.point, r2.mode, r2.mesh, r2.rank]]}


def s_mesh_selector_addresses_one_mesh(P, d, mp):
    assert P.mesh_id() == -1
    fired = []
    with P.faults.active("fleet.route:error%mesh1"):
        P.faults.fire("fleet.route")
        mp.setenv(P.MESH_ENV, "2")
        P.faults.fire("fleet.route")
        mp.setenv(P.MESH_ENV, "1")
        assert P.mesh_id() == 1
        with pytest.raises(P.InjectedFault):
            P.faults.fire("fleet.route")
        fired.append("mesh1")
    mp.delenv(P.MESH_ENV)
    with P.faults.active("fleet.route:error"):
        with pytest.raises(P.InjectedFault):
            P.faults.fire("fleet.route")
        fired.append("any")
    return {"fired": fired, "env": P.MESH_ENV}


# -- health leases ------------------------------------------------------------

def s_beat_gc_bounded(P, d, mp):
    kv = P.kv(d)
    lease = P.MeshLease(kv, 0, ttl=5.0)
    for _ in range(50):
        lease.renew()
    assert lease.renewals == 50
    live = kv.list_dir(P.wire.beat_dir("pa", 0))
    assert 1 <= len(live) <= 2
    age = P.MeshBoard(kv, ttl=5.0).mesh_age(0)
    assert age is not None and age < 1.0
    return {"live": sorted(live)}


def s_lease_expiry_is_typed_mesh_failure(P, d, mp):
    kv = P.kv(d)
    P.MeshLease(kv, 0, ttl=0.2).renew()
    board = P.MeshBoard(kv, ttl=0.2, join_grace=0.2)
    live = board.live_meshes([0])
    time.sleep(0.35)
    (mesh, err), = board.dead_meshes([0])
    assert isinstance(err, P.MeshFailureError) and err.age_s > 0.2
    with pytest.raises(P.MeshFailureError):
        board.check([0])
    return {"live": live, "dead": [mesh, type(err).__name__, err.mesh],
            "after": board.live_meshes([0])}


def s_clean_departure_is_typed_mesh_left(P, d, mp):
    kv = P.kv(d)
    lease = P.MeshLease(kv, 3, ttl=0.2)
    lease.renew()
    lease.leave()
    board = P.MeshBoard(kv, ttl=0.2, join_grace=0.2)
    live = board.live_meshes([3])
    time.sleep(0.3)
    (mesh, err), = board.dead_meshes([3])
    assert isinstance(err, P.MeshLeftError)
    assert not isinstance(err, P.MeshFailureError)
    return {"live": live, "dead": [mesh, type(err).__name__]}


def s_never_seen_mesh_respects_join_grace(P, d, mp):
    kv = P.kv(d)
    board = P.MeshBoard(kv, ttl=0.2, join_grace=10.0)
    out = [board.live_meshes([7]), board.dead_meshes([7])]
    board2 = P.MeshBoard(kv, ttl=0.2, join_grace=0.05)
    time.sleep(0.1)
    (_, err), = board2.dead_meshes([7])
    assert isinstance(err, P.MeshFailureError) and err.age_s is None
    return {"out": out, "err": type(err).__name__}


# -- placement ----------------------------------------------------------------

def _fake_mesh(P, kv, mesh, *, queued=0, warm=True, fp="fp-1"):
    P.MeshLease(kv, mesh, ttl=5.0).renew()
    kv.set(P.wire.load_key("pa", mesh), json.dumps({
        "t": time.time(), "mesh": mesh, "tier": "dcn",
        "projection": {"queued_cost_bytes": queued,
                       "inflight_cost_bytes": 0},
        "plans": {"fft": fp}, "warm": [fp] if warm else []}))


def s_placement_prefers_warm_fingerprint(P, d, mp):
    kv = P.kv(d)
    _fake_mesh(P, kv, 1, warm=False)
    _fake_mesh(P, kv, 2, warm=True)
    router = P.FleetRouter(kv, ttl=5.0)
    router.register_mesh(1)
    router.register_mesh(2)
    mesh, score = router._place("fft", 1024, None)
    assert mesh == 2 and score["affinity"] == 0.0
    return {"mesh": mesh, "score": score}


def s_placement_prefers_shallow_backlog_and_colo(P, d, mp):
    kv = P.kv(d)
    _fake_mesh(P, kv, 1, queued=512 * 1024 * 1024)
    _fake_mesh(P, kv, 2, queued=0)
    router = P.FleetRouter(kv, ttl=5.0)
    router.register_mesh(1)
    router.register_mesh(2)
    mesh, _ = router._place("fft", 1024, None)
    kv2 = P.kv(d, "kv2")
    _fake_mesh(P, kv2, 1)
    _fake_mesh(P, kv2, 2)
    router2 = P.FleetRouter(kv2, ttl=5.0)
    router2.register_mesh(1, tier="colo")
    router2.register_mesh(2)
    mesh2, score2 = router2._place("fft", 1024, None)
    assert mesh == 2 and mesh2 == 1 and score2["wire"] == 0.0
    return {"meshes": [mesh, mesh2], "score2": score2}


def s_no_live_mesh_is_typed_admission_error(P, d, mp):
    router = P.FleetRouter(P.kv(d), ttl=0.2)
    router.register_mesh(1)
    with pytest.raises(P.AdmissionError) as ei:
        router.submit("acme", np.zeros((4, 4), np.complex64), name="fft")
    assert ei.value.reason == "no-mesh" and ei.value.tenant == "acme"
    return {"reason": ei.value.reason, "stats": router.stats()}


def s_discover_registers_exporting_meshes(P, d, mp):
    kv = P.kv(d)
    _fake_mesh(P, kv, 4)
    _fake_mesh(P, kv, 9)
    router = P.FleetRouter(kv, ttl=5.0)
    found = sorted(router.discover())
    return {"found": found, "meshes": router.meshes(),
            "again": router.discover()}


# -- end-to-end over the wire -------------------------------------------------

def s_single_mesh_end_to_end(P, d, mp):
    P.obs.enable(str(d / "obs"))
    kv = P.kv(d)
    worker = P.worker(kv, 1)
    worker.start()
    router = P.FleetRouter(kv, ttl=0.3)
    router.register_mesh(1)
    try:
        u = host(2)
        t = router.submit("acme", u, name="fft")
        assert worker.step() == 1
        router.pump()
        got = np.asarray(t.result(5.0))
        _fft_close(got, u)
        stats = router.stats()
        wire_left = [kv.list_dir(P.wire.req_dir("pa", 1)),
                     kv.try_get(P.wire.res_key("pa", t.id))]
    finally:
        worker.close()
        router.close()
        P.obs.disable()
    events = P.events.read_journal(str(d / "obs"))
    assert P.obs.lint_journal(events) == []
    return {"fft": {"u": got}, "stats": stats, "wire_left": wire_left,
            "journal": P.records(d / "obs")}


def s_typed_error_crosses_the_wire(P, d, mp):
    kv = P.kv(d)
    worker = P.worker(kv, 1)
    worker.start()
    router = P.FleetRouter(kv, ttl=0.3)
    router.register_mesh(1)
    try:
        with P.faults.active("fleet.route:error@2"):
            t = router.submit("acme", host(3), name="fft")
            worker.step()
        router.pump()
        with pytest.raises(P.InjectedFault):
            t.result(5.0)
        return {"point": t.error().point, "stats": router.stats()}
    finally:
        worker.close()
        router.close()


def s_router_deadline_safety_net(P, d, mp):
    kv = P.kv(d)
    worker = P.worker(kv, 1)
    worker.start()
    router = P.FleetRouter(kv, ttl=5.0, slos={"acme": P.SLO(deadline_s=0.05)})
    router.register_mesh(1)
    try:
        t = router.submit("acme", host(4), name="fft")
        time.sleep(0.1)
        router.pump()
        err = t.error()
        assert isinstance(err, P.DeadlineError)
        return {"err": [type(err).__name__, err.reason, err.deadline_s],
                "stats": router.stats()}
    finally:
        worker.close()
        router.close()


# -- failover -----------------------------------------------------------------

def s_failover_rebinds_to_sibling(P, d, mp):
    P.obs.enable(str(d / "obs"))
    kv = P.kv(d)
    w1 = P.worker(kv, 1)
    w2 = P.worker(kv, 2, warm=False)
    w1.start()
    w2.start()
    router = P.FleetRouter(kv, ttl=0.3)
    router.register_mesh(1)
    router.register_mesh(2)
    try:
        u = host(5)
        t = router.submit("acme", u, name="fft")
        placed = kv.list_dir(P.wire.req_dir("pa", 1)) != {}
        w1.stop()
        time.sleep(0.5)
        router.pump()
        stepped = w2.step()
        router.pump()
        got = np.asarray(t.result(5.0))
        _fft_close(got, u)
        stats = router.stats()
    finally:
        w1.close()
        w2.close()
        router.close()
        P.obs.disable()
    events = P.events.read_journal(str(d / "obs"))
    fo = [e for e in events if e["ev"] == "fleet.failover"]
    assert len(fo) == 1 and fo[0]["detect_s"] > 0.3
    assert P.obs.lint_journal(events) == []
    return {"fft": {"u": got}, "placed": placed, "stepped": stepped,
            "stats": stats, "journal": P.records(d / "obs")}


def s_double_failover_resolves_exactly_once(P, d, mp):
    kv = P.kv(d)
    workers = {m: P.worker(kv, m, warm=(m == 1)) for m in (1, 2, 3)}
    for w in workers.values():
        w.start()
    router = P.FleetRouter(kv, ttl=0.3)
    for m in workers:
        router.register_mesh(m)
    try:
        u = host(6)
        t = router.submit("acme", u, name="fft")
        workers[1].stop()
        time.sleep(0.5)
        router.pump()
        on2 = kv.list_dir(P.wire.req_dir("pa", 2)) != {}
        workers[2].stop()
        time.sleep(0.5)
        router.pump()
        stepped = workers[3].step()
        router.pump()
        got = np.asarray(t.result(5.0))
        _fft_close(got, u)
        return {"fft": {"u": got}, "on2": on2, "stepped": stepped,
                "stats": router.stats()}
    finally:
        for w in workers.values():
            w.close()
        router.close()


def s_published_result_survives_mesh_death(P, d, mp):
    kv = P.kv(d)
    w1 = P.worker(kv, 1)
    w2 = P.worker(kv, 2)
    w1.start()
    w2.start()
    router = P.FleetRouter(kv, ttl=0.3)
    router.register_mesh(1)
    router.register_mesh(2)
    try:
        u = host(7)
        t = router.submit("acme", u, name="fft")
        stepped = w1.step()
        w1.stop()
        time.sleep(0.5)
        router.pump()
        got = np.asarray(t.result(5.0))
        _fft_close(got, u)
        return {"fft": {"u": got}, "stepped": stepped,
                "stats": router.stats()}
    finally:
        w1.close()
        w2.close()
        router.close()


def s_all_meshes_dead_fails_typed(P, d, mp):
    kv = P.kv(d)
    w1 = P.worker(kv, 1)
    w1.start()
    router = P.FleetRouter(kv, ttl=0.3)
    router.register_mesh(1)
    try:
        t = router.submit("acme", host(8), name="fft")
        w1.stop()
        time.sleep(0.5)
        router.pump()
        err = t.error()
        assert isinstance(err, P.AdmissionError)
        return {"err": [type(err).__name__, err.reason],
                "stats": router.stats()}
    finally:
        w1.close()
        router.close()


def s_retire_via_stop_key_is_clean_departure(P, d, mp):
    kv = P.kv(d)
    sup = P.FleetSupervisor(spawn=lambda m: None, kv=kv)
    w = P.worker(kv, 5)
    w.start()
    sup.retire(5)
    out = {"stepped": w.step(), "stopped": w.stopped,
           "left": kv.try_get(P.wire.left_key("pa", 5)) is not None,
           "board": P.MeshBoard(kv, ttl=5.0).mesh_left(5)}
    w.close()
    assert out["stopped"] and out["left"] and out["board"]
    return out


# -- the fleet supervisor -----------------------------------------------------

def _demand(reason="overload"):
    return {"direction": "up", "acted": False, "detail": "no-joiner",
            "reason": reason}


def s_supervisor_is_flag_gated(P, d, mp):
    spawned = []
    sup = P.FleetSupervisor(spawn=spawned.append, cooldown_s=0.0)
    assert not sup.enabled
    return {"observed": sup.observe(_demand()), "spawned": spawned}


def s_supervisor_spawns_with_cooldown_and_cap(P, d, mp):
    spawned = []
    sup = P.FleetSupervisor(spawn=spawned.append, enabled=True,
                            cooldown_s=30.0, max_meshes=2, next_mesh=1)
    out = [sup.observe(_demand()), list(spawned), sup.observe(_demand())]
    sup2 = P.FleetSupervisor(spawn=spawned.append, enabled=True,
                             cooldown_s=0.0, max_meshes=2, next_mesh=1)
    out += [sup2.observe(_demand()), sup2.observe(_demand()),
            sup2.observe(_demand()), sup2.spawned,
            sup2.observe({"direction": "down", "acted": True}),
            sup2.observe({"direction": "up", "acted": True,
                          "detail": "no-joiner"})]
    assert out == [True, [1], False, True, True, False, [1, 2], False,
                   False]
    return {"out": out}


def s_supervisor_scan_dedupes_by_journal_identity(P, d, mp):
    jdir = str(d / "obs")
    P.obs.enable(jdir)
    for acted in (False, False, True):
        fields = dict(action="grow", reason="overload", direction="up",
                      acted=acted)
        if not acted:
            fields["detail"] = "no-joiner"
        P.obs.record_event("serve.scale", **fields)
    P.obs.disable()
    spawned = []
    sup = P.FleetSupervisor(spawn=spawned.append, enabled=True,
                            cooldown_s=0.0)
    out = [sup.scan(jdir), list(spawned), sup.scan(jdir), list(spawned),
           sup.stats()["signals_seen"]]
    assert out == [2, [1, 2], 0, [1, 2], 3]
    return {"out": out}


# -- the fleet-event lint rule ------------------------------------------------

def _write(root, rel, content):
    path = os.path.join(root, rel)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(textwrap.dedent(content))


def _lint_fixture(P, d, fleet_src, outside_src=""):
    root = str(d / "repo")
    pkgdir = P.package
    _write(root, f"{pkgdir}/obs/schema.py", """
        EVENT_TYPES = {"fleet.route": ("ticket",), "hop": ("method",)}
        """)
    _write(root, f"{pkgdir}/resilience/faults.py", """
        POINTS = frozenset({"io.open"})
        """)
    _write(root, "docs/Resilience.md", "| `io.open` |")
    _write(root, "README.md", "docs")
    _write(root, f"{pkgdir}/fleet/router.py", fleet_src)
    if outside_src:
        _write(root, f"{pkgdir}/serve/thing.py", outside_src)
    return root


def s_lint_fleet_event_rules(P, d, mp):
    root = _lint_fixture(P, d, """
        def f(obs, name):
            obs.record_event("fleet.route", ticket="t")   # fine
            obs.record_event("fleet.bogus", ticket="t")   # unregistered
            obs.record_event(name, ticket="t")            # dynamic
            obs.record_event("hop", method="x")           # not fleet.*
        """, outside_src="""
        def g(obs):
            obs.record_event("fleet.route", ticket="t")   # wrong layer
        """)
    found = sorted((f.ident, f.path.replace(os.sep, "/").split("/", 1)[1])
                   for f in P.lint.lint_tree(root)
                   if f.check == "fleet-event")
    assert found == [("fleet.bogus", "fleet/router.py"),
                     ("fleet.route", "serve/thing.py"),
                     ("fleet.router:dynamic", "fleet/router.py"),
                     ("hop", "fleet/router.py")]
    return {"found": found}


def s_lint_clean_fleet_fixture(P, d, mp):
    root = _lint_fixture(P, d, """
        def f(obs):
            obs.record_event("fleet.route", ticket="t")
        """)
    return {"found": [f.ident for f in P.lint.lint_tree(root)
                      if f.check == "fleet-event"]}


SCENARIOS = sorted(n[2:] for n, f in list(globals().items())
                   if n.startswith("s_") and callable(f))
for _name in SCENARIOS:
    globals()["test_" + _name] = _scenario_test(_name)


def test_every_jax_fleet_case_has_a_scenario():
    """The 28 cases of the JAX package's ``tests/test_fleet.py``."""
    import re

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "test_fleet.py")) as f:
        cases = sorted(re.findall(r"^def test_(\w+)\(", f.read(), re.M))
    assert len(cases) == 28 and cases == SCENARIOS


# -- beyond the JAX cases -----------------------------------------------------

def test_mixed_fleet_over_one_kv(tmp_path):
    """A JAX router places on a port mesh and a port router on a JAX
    mesh, over one ``FileKV``: each request resolves once, within the
    FFT tolerance of the reference, and the two packages' wire values
    are byte-identical (a request and a result with the same fields).
    The two federations use a namespace each: two routers in one
    namespace would mint the same ticket ids (each package counts its
    own), and ticket ids key the results."""
    J, T = pkg("jax"), pkg("torch")
    for P in (J, T):
        P.reset()
    u = host(11)
    args = dict(tenant="acme", name="fft", direction="forward",
                payload=u, t_submit=1.0, deadline_s=None, rebinds=0,
                trace="00ff")
    assert J.wire.encode_request("t9", **args) == \
        T.wire.encode_request("t9", **args)
    assert J.wire.encode_result("t9", value=u, seconds=0.25, mesh=2) == \
        T.wire.encode_result("t9", value=u, seconds=0.25, mesh=2)
    kv_j, kv_t = J.kv(tmp_path), T.kv(tmp_path)
    port_mesh = T.worker(kv_t, 1, namespace="pa")
    jax_mesh = J.worker(kv_j, 2, namespace="pb")
    port_mesh.start()
    jax_mesh.start()
    jr = J.FleetRouter(kv_j, ttl=5.0, namespace="pa")
    tr = T.FleetRouter(kv_t, ttl=5.0, namespace="pb")
    jr.register_mesh(1)
    tr.register_mesh(2)
    try:
        tj = jr.submit("acme", u, name="fft")          # JAX -> port mesh
        tt = tr.submit("acme", u, name="fft")          # port -> JAX mesh
        assert port_mesh.step() == 1 and jax_mesh.step() == 1
        jr.pump()
        tr.pump()
        ref = np.fft.fftn(u)
        for t in (tj, tt):
            got = np.asarray(t.result(5.0))
            err = np.abs(got - ref).max() / np.abs(ref).max()
            assert err <= 2e-5, err
        assert jr.stats()["completed"] == tr.stats()["completed"] == 1
        assert kv_t.list_dir(T.wire.req_dir("pa", 1)) == {}
        assert kv_t.list_dir(T.wire.req_dir("pb", 2)) == {}
    finally:
        port_mesh.close()
        jax_mesh.close()
        jr.close()
        tr.close()


@pytest.mark.parametrize("fault", ["", "fleet.route:error%rank1*1@2"])
def test_mesh_of_two_ranks_serves_a_routed_storm(tmp_path, fault):
    """A mesh of two gloo ranks (one ``MeshWorker`` and ``PlanService``
    per rank; rank 0 beats, takes and publishes, rank 1 follows its
    take) behind a router in this process: six routed requests, of two
    plans, resolve once each within the FFT tolerance.  With ``fault``,
    rank 1 alone refuses its second request at admission: the ranks
    agree on that outcome (the mesh answers it with the injected fault,
    typed, and the ranks' queues stay equal) and serve the other five."""
    import torch_rank_tasks as tasks
    from pencilarrays_tpu_torch.fleet import FleetRouter, MeshBoard
    from pencilarrays_tpu_torch.parallel.distributed import RankPool

    T = pkg("torch")
    kvroot = str(tmp_path / "kv")
    kv = T.FileKV(kvroot)
    shapes = {"minnow": (8, 6, 4), "whale": (16, 12, 8)}
    reqs = [("minnow" if i % 3 else "whale", host(100 + i,
             shapes["minnow" if i % 3 else "whale"])) for i in range(6)]
    import threading

    with RankPool(2, timeout_s=120) as pool:
        result = {}

        def serve():
            result["out"] = pool.run(tasks.fleet_mesh_case, kvroot, 7, 60.0,
                                     fault)

        th = threading.Thread(target=serve)
        th.start()
        board = MeshBoard(kv, ttl=2.0)
        deadline = time.monotonic() + 60
        while board.live_meshes([7]) != [7] and time.monotonic() < deadline:
            time.sleep(0.05)
        router = FleetRouter(kv, ttl=2.0)
        router.register_mesh(7)
        tickets = [(router.submit("acme", u, name=name), u)
                   for name, u in reqs]
        assert router.drain(60.0) == 0
        kv.set("pa/fleet/stop/m7", "stop")
        th.join(90)
        router.close()
    assert not th.is_alive()
    refused = []
    for t, u in tickets:
        if t.error() is not None:
            refused.append(str(t.error()))
            continue
        got = np.asarray(t.result(1.0))
        ref = np.fft.fftn(u)
        assert np.abs(got - ref).max() / np.abs(ref).max() <= 2e-5
    st = router.stats()
    assert st["duplicates"] == 0
    if fault:
        assert len(refused) == 1 and st["failed"] == 1, refused
        assert "injected fault at fleet.route (hit 2)" in refused[0]
    else:
        assert refused == [] and st["failed"] == 0
    assert st["completed"] + st["failed"] == 6
    out = result["out"]
    assert out[0]["handled"] == out[1]["handled"] == 6
    assert out[0]["depth"] == out[1]["depth"] == 0
