"""The partition-tolerant control plane (compare-and-set and fencing on the
KV wire, the quorum gate of membership consensus) held against the JAX
package's.

Every case of the JAX package's ``tests/test_partition.py`` runs as a
scenario through both packages: the 12 KV, fence and quorum cases
through ``torch_cluster_parity.run_both`` (the same outcomes, KV keys
and ``cluster.*`` journal records), the router WAL, router recovery and
``kv-fenced`` lint cases through ``test_torch_fleet.run_both`` (the
fleet surface: the same outcomes, WAL bytes, stats and ``fleet.*``
records, FFT results within 2e-5 of max|ref|).  The 3-process
split-brain drill of ``tests/test_partition_chaos.py`` runs on the
port's worker; its router-SIGKILL drill is in
``tests/test_torch_fleet_chaos.py``.
"""

import json
import os
import re
import textwrap
import threading
import time

import numpy as np
import pytest

from test_torch_fleet import host as fhost
from torch_cluster_parity import run_both, run_ranks


@pytest.fixture(autouse=True)
def _port_epoch_stays_zero():
    """Every case must leave the port's process-global recovery epoch at
    0 (a raised epoch leaks into every later test of the same process)."""
    yield
    from pencilarrays_tpu_torch.cluster import epoch

    assert epoch.current() == 0, \
        f"the test left the port's recovery epoch at {epoch.current()}"

# -- compare-and-set ----------------------------------------------------------


def s_set_if_create_swap_reject(P, d, mp):
    kv = P.FileKV(str(d / "kv"))
    out = [kv.set_if("ns/fence", "v1", None), kv.try_get("ns/fence"),
           kv.set_if("ns/fence", "v1b", None),
           kv.set_if("ns/fence", "v2", "stale"), kv.try_get("ns/fence"),
           kv.set_if("ns/fence", "v2", "v1"), kv.try_get("ns/fence")]
    assert out == [True, "v1", False, False, "v1", True, "v2"]
    return {"out": out, "kv": ["kv"]}


def s_set_if_exactly_one_concurrent_winner(P, d, mp):
    kv = P.FileKV(str(d / "kv"))
    wins = []

    def racer(i):
        if kv.set_if("race/key", f"winner-{i}", None):
            wins.append(i)

    threads = [threading.Thread(target=racer, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert len(wins) == 1
    assert kv.try_get("race/key") == f"winner-{wins[0]}"
    assert not os.path.exists(str(d / "kv" / "race" / "key.lock"))
    return {"winners": len(wins), "kv": ["kv"]}


def s_set_if_broken_lock_is_recovered(P, d, mp):
    mp.setattr(P.FileKV, "CAS_LOCK_TIMEOUT_S", 0.2)
    kv = P.FileKV(str(d / "kv"))
    kv.set("a/k", "v0")
    with open(str(d / "kv" / "a" / "k.lock"), "w"):
        pass                             # the crashed holder's wreckage
    t0 = time.monotonic()
    swapped = kv.set_if("a/k", "v1", "v0")
    assert time.monotonic() - t0 >= 0.15
    return {"swapped": swapped, "value": kv.try_get("a/k"), "kv": ["kv"]}


# -- the kv.get / kv.set fault points -----------------------------------------

def s_kv_partition_mode_is_typed_and_total(P, d, mp):
    kv = P.FileKV(str(d / "kv"))
    kv.set("pre/r0", "there")
    with P.faults.active("kv.set:partition"):
        for op in (lambda: kv.set("pre/r1", "x"),
                   lambda: kv.set_if("pre/r1", "x", None),
                   lambda: kv.delete("pre/r0")):
            with pytest.raises(P.ConsensusTimeoutError):
                op()
    kept = kv.try_get("pre/r0")
    with P.faults.active("kv.get:partition"):
        hidden = kv.try_get("pre/r0")
        with pytest.raises(P.ConsensusTimeoutError):
            kv.get("pre/r0", 0.2)
    return {"kept": kept, "hidden": hidden, "healed": kv.try_get("pre/r0"),
            "kv": ["kv"]}


def s_kv_drop_mode_loses_silently(P, d, mp):
    kv = P.FileKV(str(d / "kv"))
    with P.faults.active("kv.set:drop*2"):
        kv.set("a/r0", "lost")
        swapped = kv.set_if("a/r0", "lost2", None)
    lost = kv.try_get("a/r0")
    kv.set("a/r0", "kept")
    with P.faults.active("kv.get:drop"):
        dropped = kv.try_get("a/r0")
    return {"swapped": swapped, "lost": lost, "dropped": dropped,
            "kept": kv.try_get("a/r0"), "kv": ["kv"]}


# -- FileKV durability --------------------------------------------------------

def s_new_ancestor_dirs_fsynced_topdown(P, d, mp):
    synced = []
    mp.setattr(P.kv, "fsync_dir",
               lambda x: synced.append(os.path.relpath(
                   os.path.normpath(x), str(d))))
    kv = P.FileKV(str(d / "root"))
    kv.set("a/b/c/r0", "v")
    first = list(synced)
    synced.clear()
    kv.set("a/b/c/r1", "v")
    assert first == ["root", os.path.join("root", "a"),
                     os.path.join("root", "a", "b")]
    return {"first": first, "again": synced, "kv": ["root"]}


# -- FencedKV -----------------------------------------------------------------

def s_fenced_write_rejected_behind_fence(P, d, mp):
    P.obs.enable(str(d / "obs"))
    try:
        kv = P.FileKV(str(d / "kv"))
        zombie = P.FencedKV(kv, namespace="pa", generation=0, epoch=0)
        zombie.set("pa/state/r0", "v0")
        live = P.FencedKV(kv, namespace="pa", generation=0, epoch=0)
        adv = live.advance(1, 1)
        token = live.token()
        live.set("pa/state/r0", "v1")
        rejected = []
        for op in (lambda: zombie.set("pa/state/r0", "evil"),
                   lambda: zombie.set_if("pa/state/r0", "evil", "v1"),
                   lambda: zombie.delete("pa/state/r0")):
            with pytest.raises(P.FencedWriteError) as ei:
                op()
            rejected.append([list(ei.value.token), list(ei.value.fence)])
        value = zombie.try_get("pa/state/r0")
    finally:
        P.obs.disable()
    events = P.obs.read_journal(str(d / "obs"))
    assert P.obs.lint_journal(events) == []
    counters = P.metrics.registry.snapshot()["counters"]
    return {"advance": list(adv), "token": list(token),
            "rejected": rejected, "value": value,
            "fenced": counters["cluster.fenced_writes"], "kv": ["kv"]}


def s_fence_advance_is_monotonic(P, d, mp):
    kv = P.FileKV(str(d / "kv"))
    a = P.FencedKV(kv, namespace="pa")
    b = P.FencedKV(kv, namespace="pa")
    out = [a.advance(3, 1), b.advance(2, 9), b.token(), a.advance(3, 2),
           a.advance(4, 0)]
    assert out == [(3, 1), (3, 1), (3, 1), (3, 2), (4, 0)]
    return {"out": [list(x) for x in out], "kv": ["kv"]}


def s_fence_advance_concurrent_race_converges(P, d, mp):
    kv = P.FileKV(str(d / "kv"))
    results = run_ranks(
        *[lambda g=g: P.FencedKV(kv, namespace="pa").advance(g, 0)
          for g in range(1, 7)])
    for g, got in results.items():
        assert got >= (g + 1, 0)
    final = json.loads(kv.try_get("pa/fence"))
    return {"final": final, "kv": ["kv"]}


# -- the quorum gate ----------------------------------------------------------

def s_quorum_minority_exits_typed(P, d, mp):
    P.obs.enable(str(d / "obs"))
    kv = P.FileKV(str(d / "kv"))
    coords = {r: P.Coordinator(kv, r, 3, lease_ttl=5.0, verdict_timeout=20)
              for r in range(3)}
    try:
        with pytest.raises(P.QuorumLossError) as ei:
            P.elastic.agree_membership(coords[0], timeout=0.4,
                                       max_rounds=2)
        assert isinstance(ei.value, P.ReformError)
        out = {"have": list(ei.value.have), "need": ei.value.need,
               "of": list(ei.value.of)}
    finally:
        for c in coords.values():
            c.shutdown()
        P.obs.disable()
    events = P.obs.read_journal(str(d / "obs"))
    assert P.obs.lint_journal(events) == []
    q = [e for e in events if e["ev"] == "cluster.quorum"]
    out["last"] = {k: q[-1][k] for k in ("verdict", "have", "gone")}
    return out


def s_quorum_majority_reforms_over_dead_peer(P, d, mp):
    P.obs.enable(str(d / "obs"))
    kv = P.FileKV(str(d / "kv"))
    coords = {r: P.Coordinator(kv, r, 3, lease_ttl=0.4, verdict_timeout=20)
              for r in range(3)}
    coords[2].shutdown()
    time.sleep(0.9)
    try:
        res = run_ranks(
            lambda: P.elastic.agree_membership(coords[0], timeout=20,
                                               reason="peer-failure"),
            lambda: P.elastic.agree_membership(coords[1], timeout=20,
                                               reason="peer-failure"))
        out = {"members": [res[0].members, res[1].members],
               "gen": [res[0].gen, res[1].gen]}
    finally:
        for r in (0, 1):
            coords[r].shutdown()
        P.obs.disable()
    events = P.obs.read_journal(str(d / "obs"))
    assert P.obs.lint_journal(events) == []
    out["quorum"] = sorted(
        [e["rank"], e["verdict"], e["of"], e["need"], e["gone"]]
        for e in events if e["ev"] == "cluster.quorum")
    return out


def s_quorum_escape_hatch_is_loud(P, d, mp):
    mp.setenv(P.elastic.QUORUM_VAR, "off")
    P.obs.enable(str(d / "obs"))
    kv = P.FileKV(str(d / "kv"))
    coords = {r: P.Coordinator(kv, r, 3, lease_ttl=5.0, verdict_timeout=20)
              for r in range(3)}
    try:
        with pytest.warns(RuntimeWarning, match="split-brain"):
            with pytest.raises(P.ReformError) as ei:
                P.elastic.agree_membership(coords[0], timeout=0.3,
                                           max_rounds=1)
        assert not isinstance(ei.value, P.QuorumLossError)
    finally:
        for c in coords.values():
            c.shutdown()
        P.obs.disable()
    events = P.obs.read_journal(str(d / "obs"))
    q = [e for e in events if e["ev"] == "cluster.quorum"]
    return {"last": q[-1]["verdict"]}


SCENARIOS = sorted(n[2:] for n, f in list(globals().items())
                   if n.startswith("s_") and callable(f))


@pytest.mark.parametrize("name", SCENARIOS)
def test_partition_matches_jax(name, tmp_path, monkeypatch):
    """One KV, fence or quorum case of the JAX package's
    ``test_partition.py`` through both packages."""
    run_both(globals()["s_" + name], tmp_path, monkeypatch)


# -- the router WAL: framing, replay, rotation (the fleet surface) ------------

def _append_all(P, wal_dir, records, **kw):
    w = P.wal.RouterWAL(str(wal_dir), **kw)
    for rec in records:
        w.append(rec)
    w.close()


def _wal_bytes(P, wal_dir):
    """Every WAL file's bytes, by name."""
    out = {}
    for n in sorted(os.listdir(str(wal_dir))):
        with open(os.path.join(str(wal_dir), n), "rb") as f:
            out[n] = f.read().decode()
    return out


def f_wal_roundtrip_and_torn_tail(P, d, mp):
    recs = [{"op": "admit", "tid": "t1", "req": {"x": 1}},
            {"op": "place", "tid": "t1", "mesh": 0, "rebinds": 0},
            {"op": "complete", "tid": "t1", "outcome": "ok"}]
    _append_all(P, d, recs)
    out = [P.wal.read_wal(str(d))]
    with open(os.path.join(str(d), P.wal.ACTIVE), "a") as f:
        f.write(P.wal._frame({"op": "admit", "tid": "t2", "req": {}})[:20])
    out.append(P.wal.read_wal(str(d)))
    with open(os.path.join(str(d), P.wal.ACTIVE), "a") as f:
        f.write('\n{"op": "complete", "tid": "t1", "outcome": "ok"}\n')
    out.append(P.wal.read_wal(str(d)))
    assert [o[1] for o in out] == [0, 1, 2]
    assert all(o[0] == recs for o in out)
    return {"reads": [list(o) for o in out], "bytes": _wal_bytes(P, d)}


def f_wal_replay_fold_semantics(P, d, mp):
    recs = [
        {"op": "admit", "tid": "a", "req": "RA"},
        {"op": "place", "tid": "a", "mesh": 0, "rebinds": 0},
        {"op": "admit", "tid": "b", "req": "RB"},
        {"op": "place", "tid": "b", "mesh": 1, "rebinds": 0},
        {"op": "place", "tid": "b", "mesh": 2, "rebinds": 1},
        {"op": "complete", "tid": "b", "outcome": "ok"},
        {"op": "complete", "tid": "b", "outcome": "ok"},
        {"op": "complete", "tid": "c", "outcome": "ok"},
        {"op": "admit", "tid": "c", "req": "RC"},
        {"op": "place", "tid": "zzz", "mesh": 0},
    ]
    st = P.wal.replay(recs)
    assert set(st["pending"]) == {"a"}
    assert st["pending"]["a"] == {"req": "RA", "mesh": 0, "rebinds": 0}
    assert st["resolved"] == {"b", "c"} and st["duplicates"] == 1
    assert P.wal.replay(recs) == st
    return {"pending": st["pending"], "resolved": sorted(st["resolved"]),
            "duplicates": st["duplicates"]}


def f_wal_rotation_preserves_order(P, d, mp):
    recs = [{"op": "place", "tid": f"t{i:03d}", "mesh": 0, "rebinds": 0}
            for i in range(20)]
    _append_all(P, d, recs, max_bytes=200)
    segments = [n for n in os.listdir(str(d))
                if P.wal._SEGMENT_RE.match(n)]
    assert len(segments) >= 2
    got, skipped = P.wal.read_wal(str(d))
    assert got == recs and skipped == 0
    return {"bytes": _wal_bytes(P, d)}


def f_wal_rotation_cap_from_env(P, d, mp):
    mp.setenv("PENCILARRAYS_TPU_FLEET_WAL_MAX_MB", "0.0001")
    recs = [{"op": "place", "tid": f"t{i:03d}", "mesh": 0, "rebinds": 0}
            for i in range(8)]
    _append_all(P, d, recs)
    assert any(P.wal._SEGMENT_RE.match(n) for n in os.listdir(str(d)))
    got, _ = P.wal.read_wal(str(d))
    assert got == recs
    return {"bytes": _wal_bytes(P, d)}


# -- router recovery: exactly-once across router incarnations ----------------

def f_router_death_after_results_resolves_without_reexecution(P, d, mp):
    P.obs.enable(str(d / "obs"))
    kv = P.kv(d)
    wal_dir = str(d / "wal")
    worker = P.worker(kv, 0, ttl=5.0)
    worker.start()
    r2 = None
    try:
        r1 = P.FleetRouter(kv, ttl=5.0, wal_dir=wal_dir)
        r1.register_mesh(0)
        r1.submit("acme", fhost(0), name="fft")
        r1.submit("acme", fhost(1), name="fft")
        recs, _ = P.wal.read_wal(wal_dir)
        ops = [r["op"] for r in recs]
        stepped = worker.step()
        r1._wal.close()
        del r1
        r2 = P.FleetRouter(kv, ttl=5.0, wal_dir=wal_dir)
        r2.register_mesh(0)
        rep = r2.recover()
        left = r2.drain(5.0)
        st = r2.stats()
        wire_left = kv.list_dir(P.wire.req_dir("pa", 0))
        rep2 = r2.recover()
    finally:
        worker.close()
        if r2 is not None:
            r2.close()
        P.obs.disable()
    events = P.events.read_journal(str(d / "obs"))
    assert P.obs.lint_journal(events) == []
    counters = P.metrics.registry.snapshot()["counters"]
    assert rep["reparked"] == 2 and st["completed"] == 2
    return {"ops": ops, "stepped": stepped, "rep": rep, "left": left,
            "stats": st, "wire_left": wire_left, "rep2": rep2,
            "wals": [w["reparked"] for w in events
                     if w["ev"] == "fleet.wal"],
            "replays": counters["fleet.wal_replays{outcome=clean}"]}


def f_router_death_before_execution_rebinds_and_resolves(P, d, mp):
    kv = P.kv(d)
    wal_dir = str(d / "wal")
    worker = P.worker(kv, 0, ttl=5.0)
    worker.start()
    r2 = None
    try:
        r1 = P.FleetRouter(kv, ttl=5.0, wal_dir=wal_dir)
        r1.register_mesh(0)
        u = fhost(7)
        r1.submit("acme", u, name="fft")
        r1._wal.close()
        del r1
        r2 = P.FleetRouter(kv, ttl=5.0, wal_dir=wal_dir)
        r2.register_mesh(0)
        rep = r2.recover()
        r2.pump()
        rebound = r2.stats()["rebound"]
        stepped = worker.step()
        left = r2.drain(5.0)
        st = r2.stats()
        recs, _ = P.wal.read_wal(wal_dir)
        req = next(r["req"] for r in recs if r["op"] == "admit")
        np.testing.assert_array_equal(
            P.wire.decode_request(req)["payload"], u)
    finally:
        worker.close()
        if r2 is not None:
            r2.close()
    assert rep["reparked"] == 1 and rebound == 1 and stepped == 1
    return {"rep": rep, "rebound": rebound, "stepped": stepped,
            "left": left, "stats": st}


def f_recovered_deadline_lapses_typed(P, d, mp):
    kv = P.kv(d)
    wal_dir = str(d / "wal")
    worker = P.worker(kv, 0, ttl=5.0)
    worker.start()
    r2 = None
    try:
        slos = {"whale": P.SLO(deadline_s=0.15)}
        r1 = P.FleetRouter(kv, ttl=5.0, slos=slos, wal_dir=wal_dir)
        r1.register_mesh(0)
        r1.submit("whale", fhost(3), name="fft")
        r1._wal.close()
        del r1
        for k in list(kv.list_dir(P.wire.req_dir("pa", 0))):
            kv.delete(k)
        time.sleep(0.25)
        r2 = P.FleetRouter(kv, ttl=5.0, slos=slos, wal_dir=wal_dir)
        r2.register_mesh(0)
        reparked = r2.recover()["reparked"]
        r2.pump()
        st = r2.stats()
        recs, _ = P.wal.read_wal(wal_dir)
    finally:
        worker.close()
        if r2 is not None:
            r2.close()
    final = [r["outcome"] for r in recs if r["op"] == "complete"]
    assert reparked == 1 and st["expired"] == 1 and st["failed"] == 1
    assert final == ["DeadlineError"]
    return {"reparked": reparked, "stats": st, "final": final}


def f_recovery_with_torn_tail_still_resolves_committed(P, d, mp):
    kv = P.kv(d)
    wal_dir = str(d / "wal")
    worker = P.worker(kv, 0, ttl=5.0)
    worker.start()
    r2 = None
    try:
        r1 = P.FleetRouter(kv, ttl=5.0, wal_dir=wal_dir)
        r1.register_mesh(0)
        r1.submit("acme", fhost(4), name="fft")
        worker.step()
        r1._wal.close()
        del r1
        with open(os.path.join(wal_dir, P.wal.ACTIVE), "a") as f:
            f.write(P.wal._frame({"op": "admit", "tid": "torn",
                                  "req": "x" * 64})[:30])
        r2 = P.FleetRouter(kv, ttl=5.0, wal_dir=wal_dir)
        r2.register_mesh(0)
        rep = r2.recover()
        left = r2.drain(5.0)
        st = r2.stats()
    finally:
        worker.close()
        if r2 is not None:
            r2.close()
    assert rep["outcome"] == "torn-tail" and rep["skipped"] == 1
    assert rep["reparked"] == 1 and st["completed"] == 1
    return {"rep": rep, "left": left, "stats": st}


# -- the kv-fenced lint rule --------------------------------------------------

def _write(root, rel, content):
    path = os.path.join(root, *rel.split("/"))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(textwrap.dedent(content))


def _kv_lint_fixture(P, d, cluster_src, outside_src=""):
    root = str(d / "repo")
    _write(root, f"{P.package}/obs/schema.py", """
        EVENT_TYPES = {"hop": ("method",)}
        """)
    _write(root, f"{P.package}/resilience/faults.py", """
        POINTS = frozenset({"io.open"})
        """)
    _write(root, "docs/Resilience.md", "| `io.open` |")
    _write(root, "README.md", "docs")
    _write(root, f"{P.package}/cluster/health.py", cluster_src)
    if outside_src:
        _write(root, f"{P.package}/serve/thing.py", outside_src)
    return root


def f_lint_kv_fenced_rules(P, d, mp):
    root = _kv_lint_fixture(P, d, """
        def renew(self, kv):
            kv.set("lease/r0", "t")                    # raw: flagged
            kv.delete("lease/r0")   # kv-unfenced: GC of my own key
            self.fenced.set("lease/r0", "t")           # sanctioned
            kv.set("lease/r1", "t")  # kv-unfenced:
            # kv-unfenced: the block-above form of the excuse
            kv.set_if("fence", "v", None)
            board.publish("x")                         # not a KV write
        """, outside_src="""
        def g(kv):
            kv.set("free/r0", "x")      # serve/ is out of scope
        """)
    found = sorted((f.ident, f.line) for f in P.lint.lint_tree(root)
                   if f.check == "kv-fenced")
    assert found == [("cluster.health.renew", 3),
                     ("cluster.health.renew", 6)]
    return {"found": found}


def f_lint_kv_fenced_clean_fixture(P, d, mp):
    root = _kv_lint_fixture(P, d, """
        def renew(self, kv):
            self.fenced.set("lease/r0", "t")
            kv.delete("lease/r0")   # kv-unfenced: my own key
        """)
    return {"found": [f.ident for f in P.lint.lint_tree(root)
                      if f.check == "kv-fenced"]}


def f_kv_fenced_rule_is_clean_on_this_tree(P, d, mp):
    """Each package's tree holds the bar the rule sets (the port's
    ``cluster/`` and ``fleet/`` under its own linter)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return {"found": [f.ident for f in P.lint.lint_tree(root)
                      if f.check == "kv-fenced"]}


FLEET_SCENARIOS = sorted(n[2:] for n, f in list(globals().items())
                         if n.startswith("f_") and callable(f))


@pytest.mark.parametrize("name", FLEET_SCENARIOS)
def test_partition_fleet_matches_jax(name, tmp_path, monkeypatch):
    """One router-WAL, router-recovery or lint case of the JAX package's
    ``test_partition.py`` through both packages' fleet surface."""
    from test_torch_fleet import run_both as fleet_run_both

    fleet_run_both(globals()["f_" + name], tmp_path, monkeypatch)


def test_every_jax_partition_case_has_a_scenario():
    """All 23 cases of ``test_partition.py``: the 12 KV, fence and
    quorum scenarios and the 11 WAL, router and lint ones."""
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "test_partition.py")) as f:
        src = f.read()
    cases = sorted(re.findall(r"^def test_(\w+)\(", src, re.M))
    assert len(SCENARIOS) == 12 and len(FLEET_SCENARIOS) == 11
    assert len(cases) == 23 and cases == sorted(SCENARIOS + FLEET_SCENARIOS)


def test_fenced_store_kv_rejects_a_zombie(tmp_path):
    """FencedKV over the torch.distributed store backend: the same fence
    record, the same typed rejection."""
    from datetime import timedelta

    import torch.distributed as tdist

    from pencilarrays_tpu_torch.cluster import FencedWriteError
    from pencilarrays_tpu_torch.cluster.kv import FencedKV, StoreKV

    store = tdist.TCPStore("localhost", 0, 1, True,
                           timeout=timedelta(seconds=30))
    kv = StoreKV(store)
    zombie = FencedKV(kv, namespace="pa")
    zombie.set("pa/state/r0", "v0")
    assert FencedKV(kv, namespace="pa").advance(2, 1) == (2, 1)
    assert json.loads(kv.try_get("pa/fence")) == {"gen": 2, "epoch": 1}
    with pytest.raises(FencedWriteError):
        zombie.set("pa/state/r0", "evil")
    assert kv.try_get("pa/state/r0") == "v0"


def test_quorum_partition_across_processes(tmp_path):
    """3 worker processes, rank 2 partitioned off the KV wire mid-run:
    typed minority exit, majority reformation, fenced zombie write, the
    journal lint-clean end to end."""
    import test_torch_cluster as tc

    outs = tc._launch(tmp_path, 3, "partition", timeout=120)
    assert "MINORITY_TYPED have=1 need=2 of=3" in outs[2], outs[2]
    assert "ZOMBIE_FENCED token=(0, 0) fence=(1," in outs[2], outs[2]
    for rank in (0, 1):
        assert "REFORMED gen=1 world=2 ns=pa.g1" in outs[rank], outs[rank]
    events = tc._events(tmp_path)
    quorum = [e for e in events if e["ev"] == "cluster.quorum"]
    fails = [e for e in quorum if e["verdict"] == "fail"]
    assert fails and all(e["proc"] == 2 and e["have"] == [2]
                         and e["need"] == 2 for e in fails), quorum
    passes = [e for e in quorum if e["verdict"] == "pass"
              and e["proc"] in (0, 1)]
    assert any(e["of"] == [0, 1] and e["gone"] == [2] for e in passes)
    assert not any(e["verdict"] == "bypass" for e in quorum)
    adv = [e for e in events if e["ev"] == "cluster.reform"
           and e.get("stage") == "fence"]
    assert len(adv) == 1 and adv[0]["proc"] == 0 and \
        adv[0]["fence_gen"] == 1, adv
    fenced = [e for e in events if e["ev"] == "cluster.fence"]
    assert fenced and all(e["proc"] == 2 and e["gen"] == 0
                          and e["fence_gen"] == 1 for e in fenced), fenced
    from pencilarrays_tpu_torch.obs.__main__ import main

    assert main(["lint", str(tmp_path / "obs")]) == 0
    assert main(["timeline", str(tmp_path / "obs")]) == 0
