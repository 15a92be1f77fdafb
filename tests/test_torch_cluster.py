"""The cluster layer (consensus, leases, epochs, elastic reformation) held
against the JAX package's.

Every case of the JAX package's ``tests/test_cluster.py`` runs as a
scenario through both packages (``torch_cluster_parity.run_both``):
in-process ranks are threads over one ``FileKV``, and the port's agreed
verdicts, memberships, epochs, KV key names and ``cluster.*`` journal
records must equal JAX's, key by key.  Beside them: a mixed mesh (a JAX
coordinator and a port coordinator on one ``FileKV``), ``StoreKV`` over
the ``torch.distributed`` stores, and subprocess drills of the JAX
package's ``test_multiprocess.py`` cluster phases at 16^3 on the CPU.
"""

import json
import os
import re
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

import torch_cluster_parity as par
from torch_cluster_parity import run_both, run_ranks, tear

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_cluster_worker.py")

OK = {"status": "ok", "can_retry": True, "can_restore": True}
BAD = {"status": "integrity", "can_retry": True, "can_restore": True,
       "error": "sdc"}


def _pair(P, d, *, ttl=10.0, timeout=30.0, sub="kv"):
    kv = P.FileKV(os.path.join(str(d), sub))
    return (P.Coordinator(kv, 0, 2, lease_ttl=ttl, verdict_timeout=timeout),
            P.Coordinator(kv, 1, 2, lease_ttl=ttl, verdict_timeout=timeout))


def _verdict(v):
    return {k: v[k] for k in ("action", "ranks", "epoch", "round")
            if k in v}


@pytest.fixture(autouse=True)
def _port_epoch_stays_zero():
    """Every case must leave the port's process-global recovery epoch at
    0: a raised epoch leaks into every later test of the same process
    (the JAX package's epoch is not checked: its own tests, run earlier
    in a worker, may leave it raised)."""
    yield
    from pencilarrays_tpu_torch.cluster import epoch

    assert epoch.current() == 0, \
        f"the test left the port's recovery epoch at {epoch.current()}"


# -- KV backend ---------------------------------------------------------------

def s_filekv_roundtrip(P, d, mp):
    kv = P.FileKV(str(d / "kv"))
    seen = [kv.try_get("a/b/r0")]
    kv.set("a/b/r0", "hello")
    seen += [kv.try_get("a/b/r0"), kv.get("a/b/r0", 1.0)]
    kv.set("a/b/r0", "v2")
    seen.append(kv.try_get("a/b/r0"))
    kv.delete("a/b/r0")
    seen.append(kv.try_get("a/b/r0"))
    kv.delete("a/b/r0")
    return {"seen": seen, "kv": ["kv"]}


def s_filekv_get_timeout_is_typed(P, d, mp):
    kv = P.FileKV(str(d / "kv"))
    t0 = time.monotonic()
    with pytest.raises(P.ConsensusTimeoutError) as ei:
        kv.get("never/r9", 0.3)
    assert time.monotonic() - t0 < 5.0
    return {"key": ei.value.key}


def s_filekv_rejects_traversal_keys(P, d, mp):
    kv = P.FileKV(str(d / "kv"))
    for bad in ("../escape", "a/&bad"):
        with pytest.raises(ValueError):
            kv.set(bad, "x")
    return {"kv": ["kv"]}


def s_filekv_get_on_wait_can_interrupt(P, d, mp):
    kv = P.FileKV(str(d / "kv"))

    def boom():
        raise P.PeerFailureError("peer gone", rank=1)

    with pytest.raises(P.PeerFailureError) as ei:
        kv.get("never/r1", 10.0, on_wait=boom)
    return {"rank": ei.value.rank}


# -- verdict merge (pure) -----------------------------------------------------

def s_merge_all_ok(P, d, mp):
    return P.merge_statuses([{"status": "ok"}, {"status": "ok"}])


def s_merge_retry_needs_everyones_budget(P, d, mp):
    v1 = P.merge_statuses([OK, BAD])
    v2 = P.merge_statuses([dict(OK, can_retry=False), BAD])
    assert v1["action"] == "retry" and v2["action"] == "restore"
    return {"v1": v1, "v2": v2}


def s_merge_raise_when_nothing_left(P, d, mp):
    v = P.merge_statuses([
        {"status": "hang", "can_retry": False, "can_restore": False,
         "error": "stuck"},
        {"status": "ok", "can_retry": False, "can_restore": True}])
    assert v["action"] == "raise"
    return v


# -- consensus rounds and epochs ----------------------------------------------

def s_two_rank_verdict_identical_and_epoch_advances(P, d, mp):
    P.obs.enable(str(d / "obs"))
    c0, c1 = _pair(P, d)
    try:
        a = run_ranks(lambda: c0.agree("step", OK),
                      lambda: c1.agree("step", BAD))
        assert a[0] == a[1] and a[0]["action"] == "retry"
        b = run_ranks(lambda: c0.agree("step", OK),
                      lambda: c1.agree("step", OK))
        events = P.obs.read_journal(str(d / "obs"))
        assert P.obs.lint_journal(events) == []
        counters = sorted(k for k in P.obs.snapshot()["counters"]
                          if k.startswith("cluster."))
        return {"first": _verdict(a[0]), "second": _verdict(b[0]),
                "epoch": P.epoch.current(), "counters": counters,
                "advances": [e["epoch"] for e in events
                             if e["ev"] == "guard.epoch"],
                "kv": ["kv"]}
    finally:
        c0.shutdown()
        c1.shutdown()
        P.obs.disable()


def s_round_keys_garbage_collected(P, d, mp):
    c0, c1 = _pair(P, d)
    ok = {"status": "ok", "can_retry": True, "can_restore": False}
    try:
        for _ in range(5):
            run_ranks(lambda: c0.agree("step", ok),
                      lambda: c1.agree("step", ok))
        rounds = [k for k in par.kv_keys(d / "kv") if "/round/" in k]
        assert len(rounds) <= 4, rounds
        return {"rounds": rounds}
    finally:
        c0.shutdown()
        c1.shutdown()


def s_gate_tokens_case_insensitive(P, d, mp):
    for off in ("OFF", "Off", "FALSE", "0"):
        mp.setenv(P.cluster.ENV_VAR, off)
        assert not P.cluster.enabled(), off
        assert P.cluster.coordinator() is None
    for on in ("True", "ON", "1"):
        # the runtime store backend: no client in this process -> a
        # clear RuntimeError, never a FileKV('True')
        with pytest.raises(RuntimeError):
            P.kv.resolve_kv(on)
    return {"file": type(P.kv.resolve_kv(str(d / "kv"))).__name__}


def s_agree_steps_intersection(P, d, mp):
    c0, c1 = _pair(P, d)
    try:
        a = run_ranks(lambda: c0.agree_steps("ck", [1, 2, 3]),
                      lambda: c1.agree_steps("ck", [1, 3, 4]))
        b = run_ranks(lambda: c0.agree_steps("ck", [7]),
                      lambda: c1.agree_steps("ck", []))
        assert a[0] == a[1] and b[0] == b[1]
        return {"a": a[0], "b": b[0], "kv": ["kv"]}
    finally:
        c0.shutdown()
        c1.shutdown()


# -- peer health leases -------------------------------------------------------

def s_lease_expiry_raises_typed_peer_failure(P, d, mp):
    P.guard.enable(str(d / "bundles"))
    kv = P.FileKV(str(d / "kv"))
    a = P.LeaseBoard(kv, 0, 2, ttl=0.3)
    b = P.LeaseBoard(kv, 1, 2, ttl=0.3)
    a.start()
    b.start()
    a.check_peers()
    b.stop()
    time.sleep(0.9)
    with pytest.raises(P.PeerFailureError) as ei:
        a.check_peers()
    a.stop()
    e = ei.value
    assert e.rank == 1 and e.age_s > 0.3
    with open(os.path.join(e.bundle, "MANIFEST.json")) as f:
        man = json.load(f)
    return {"rank": e.rank, "reason": man["reason"],
            "peer_rank": man["peer_rank"], "kv": ["kv"]}


def s_never_joined_peer_fails_after_grace(P, d, mp):
    P.guard.enable(str(d / "bundles"))
    kv = P.FileKV(str(d / "kv"))
    a = P.LeaseBoard(kv, 0, 2, ttl=0.2)
    a.join_grace = 0.4
    a.start()
    a.check_peers()
    time.sleep(0.5)
    with pytest.raises(P.PeerFailureError) as ei:
        a.check_peers()
    a.stop()
    return {"rank": ei.value.rank, "age": ei.value.age_s}


def s_transient_lease_read_failure_is_not_death(P, d, mp):
    kv = P.FileKV(str(d / "kv"))
    a = P.LeaseBoard(kv, 0, 2, ttl=5.0)
    b = P.LeaseBoard(kv, 1, 2, ttl=5.0)
    a.join_grace = 0.0
    a.start()
    b.start()
    a.check_peers()
    kv.delete("pa/lease/r1")
    a.check_peers()
    b.renew()
    a.check_peers()
    a.stop()
    b.stop()
    return {"kv": ["kv"]}


def s_join_grace_knob(P, d, mp):
    mp.setenv(P.cluster.ENV_VAR, str(d / "kv"))
    mp.setenv(P.cluster.RANK_VAR, "0")
    mp.setenv(P.cluster.WORLD_VAR, "2")
    mp.setenv(P.cluster.JOIN_GRACE_VAR, "123.5")
    c = P.cluster.coordinator()
    grace = c.leases.join_grace
    P.cluster._reset_for_tests()
    return {"grace": grace}


def s_lease_renewal_keeps_peer_alive(P, d, mp):
    kv = P.FileKV(str(d / "kv"))
    a = P.LeaseBoard(kv, 0, 2, ttl=0.5, interval=0.1)
    b = P.LeaseBoard(kv, 1, 2, ttl=0.5, interval=0.1)
    a.start()
    b.start()
    for _ in range(4):
        time.sleep(0.2)
        a.check_peers()
        b.check_peers()
    a.stop()
    b.stop()
    return {"kv": ["kv"]}


# -- agreed-checkpoint election -----------------------------------------------

def s_common_latest_valid_agrees_on_oldest_common_step(P, d, mp):
    truth = np.random.default_rng(3).standard_normal((11, 9, 13))
    pen, u1 = P.mk_state(truth)
    _, u2 = P.mk_state(truth + 5.0)
    mgrs = {}
    for r in range(2):
        mgrs[r] = P.CheckpointManager(str(d / f"ck{r}"), keep=4)
        mgrs[r].save(1, {"u": u1})
        mgrs[r].save(2, {"u": u2})
    tear(d / "ck0", 2)
    local = [mgrs[0].latest_valid(), mgrs[1].latest_valid()]
    c0, c1 = _pair(P, d)
    try:
        res = run_ranks(
            lambda: mgrs[0].common_latest_valid(coordinator=c0),
            lambda: mgrs[1].common_latest_valid(coordinator=c1))
        backs = run_ranks(
            lambda: P.gather(mgrs[0].restore(1).read("u", pen)),
            lambda: P.gather(mgrs[1].restore(1).read("u", pen)))
        assert np.array_equal(backs[0], truth)
        assert np.array_equal(backs[0], backs[1])
        return {"local": local, "agreed": [res[0], res[1]], "kv": ["kv"]}
    finally:
        c0.shutdown()
        c1.shutdown()


def s_common_latest_valid_none_when_no_common_step(P, d, mp):
    truth = np.random.default_rng(4).standard_normal((8, 6, 4))
    _, u = P.mk_state(truth)
    m0 = P.CheckpointManager(str(d / "ck0"), keep=4)
    m1 = P.CheckpointManager(str(d / "ck1"), keep=4)
    m0.save(1, {"u": u})
    m1.save(2, {"u": u})
    c0, c1 = _pair(P, d)
    try:
        res = run_ranks(lambda: m0.common_latest_valid(coordinator=c0),
                        lambda: m1.common_latest_valid(coordinator=c1))
        return {"agreed": [res[0], res[1]]}
    finally:
        c0.shutdown()
        c1.shutdown()


def s_common_latest_valid_degrades_to_latest_valid(P, d, mp):
    truth = np.random.default_rng(5).standard_normal((8, 6, 4))
    _, u = P.mk_state(truth)
    m = P.CheckpointManager(str(d / "ck"), keep=4)
    m.save(3, {"u": u})
    return {"common": m.common_latest_valid(), "latest": m.latest_valid(),
            "valid": m.valid_steps()}


# -- the mesh guarded_step ----------------------------------------------------

def s_mesh_guarded_step_agreed_retry(P, d, mp):
    P.obs.enable(str(d / "obs"))
    c0, c1 = _pair(P, d)
    calls = {0: 0, 1: 0}

    def make(r, coord):
        def run():
            def step():
                calls[r] += 1
                if r == 1 and calls[r] == 1:
                    raise P.IntegrityError("sdc", hop="t", kind="sum")
                return r * 10 + calls[r]
            return P.guard.guarded_step(
                step, retry=P.RetryPolicy(max_attempts=3, base_delay=0.01),
                label="mesh-retry", coordinator=coord)
        return run

    try:
        res = run_ranks(make(0, c0), make(1, c1))
        events = P.obs.read_journal(str(d / "obs"))
        assert P.obs.lint_journal(events) == []
        return {"calls": calls, "res": res,
                "actions": sorted(e["action"] for e in events
                                  if e["ev"] == "cluster.verdict"),
                "recover": sorted(e["stage"] for e in events
                                  if e["ev"] == "guard.recover"),
                "kv": ["kv"]}
    finally:
        c0.shutdown()
        c1.shutdown()
        P.obs.disable()


def s_mesh_guarded_step_agreed_raise_is_typed_everywhere(P, d, mp):
    c0, c1 = _pair(P, d)
    out = {}

    def rank0():
        with pytest.raises(P.ClusterAbortError) as ei:
            P.guard.guarded_step(lambda: 0,
                                 retry=P.RetryPolicy(max_attempts=1),
                                 label="mesh-raise", coordinator=c0)
        out["ranks"] = list(ei.value.ranks)
        out["named"] = "IntegrityError" in ei.value.errors[1]
        return True

    def rank1():
        def step():
            raise P.IntegrityError("sdc", hop="t", kind="sum")
        with pytest.raises(P.IntegrityError):
            P.guard.guarded_step(step, retry=P.RetryPolicy(max_attempts=1),
                                 label="mesh-raise", coordinator=c1)
        return True

    try:
        assert run_ranks(rank0, rank1) == {0: True, 1: True}
        return out
    finally:
        c0.shutdown()
        c1.shutdown()


def s_mesh_guarded_step_restores_agreed_step(P, d, mp):
    truth = np.random.default_rng(7).standard_normal((11, 9, 13))
    pen, u1 = P.mk_state(truth)
    pen2 = P.pencil_like(pen, (0,))
    c0, c1 = _pair(P, d)
    mgrs, states = {}, {}
    for r in range(2):
        mgrs[r] = P.CheckpointManager(str(d / f"ck{r}"), keep=4)
        mgrs[r].save(1, {"u": u1})
        mgrs[r].save(2, {"u": P.mk_state(truth + 5.0)[1]})
        states[r] = {"u": P.mk_state(truth + 1000.0)[1]}
    tear(d / "ck0", 2)
    calls = {0: 0, 1: 0}

    def make(r, coord):
        def run():
            def step():
                calls[r] += 1
                if r == 1 and calls[r] <= 2:
                    raise P.IntegrityError("sdc", hop="t", kind="sum")
                return P.transpose(states[r]["u"], pen2)

            def restore_cb(ckpt):
                states[r]["u"] = ckpt.read("u", pen)

            return P.guard.guarded_step(
                step, ckpt_mgr=mgrs[r], restore=restore_cb,
                retry=P.RetryPolicy(max_attempts=2, base_delay=0.01),
                label="mesh-restore", coordinator=coord)
        return run

    try:
        res = run_ranks(make(0, c0), make(1, c1))
        for r in range(2):
            assert np.array_equal(P.gather(res[r]), truth)
        return {"calls": calls, "epoch": P.epoch.current(), "kv": ["kv"]}
    finally:
        c0.shutdown()
        c1.shutdown()


def s_mesh_guarded_step_non_ladder_error_unblocks_peers(P, d, mp):
    c0, c1 = _pair(P, d, timeout=60.0)
    out = {}

    def rank0():
        t0 = time.monotonic()
        with pytest.raises(P.ClusterAbortError) as ei:
            P.guard.guarded_step(lambda: 0, label="app-bug",
                                 retry=P.RetryPolicy(max_attempts=1),
                                 coordinator=c0)
        out["ranks"] = list(ei.value.ranks)
        out["named"] = "ValueError" in ei.value.errors[1]
        assert time.monotonic() - t0 < 30.0
        return P.guard.guarded_step(lambda: "next", label="app-bug",
                                    retry=P.RetryPolicy(max_attempts=1),
                                    coordinator=c0)

    def rank1():
        def step():
            raise ValueError("app bug, not SDC")
        with pytest.raises(ValueError):
            P.guard.guarded_step(step, label="app-bug",
                                 retry=P.RetryPolicy(max_attempts=1),
                                 coordinator=c1)
        return P.guard.guarded_step(lambda: "next", label="app-bug",
                                    retry=P.RetryPolicy(max_attempts=1),
                                    coordinator=c1)

    try:
        out["res"] = run_ranks(rank0, rank1)
        return dict(out, kv=["kv"])
    finally:
        c0.shutdown()
        c1.shutdown()


def s_mesh_guarded_step_peer_death_mid_step(P, d, mp):
    P.guard.enable(str(d / "bundles"))
    kv = P.FileKV(str(d / "kv"))
    c0 = P.Coordinator(kv, 0, 2, lease_ttl=0.4, verdict_timeout=60.0)
    c1 = P.Coordinator(kv, 1, 2, lease_ttl=0.4, verdict_timeout=60.0)
    out = {}

    def rank0():
        t0 = time.monotonic()
        with pytest.raises(P.PeerFailureError) as ei:
            P.guard.guarded_step(lambda: 0, label="mesh-death",
                                 retry=P.RetryPolicy(max_attempts=1),
                                 coordinator=c0)
        out["rank"] = ei.value.rank
        assert time.monotonic() - t0 < 30.0
        return True

    def rank1():
        c1.shutdown()
        return True

    try:
        assert run_ranks(rank0, rank1) == {0: True, 1: True}
        return out
    finally:
        c0.shutdown()


# -- gate, identity, degrade-to-local -----------------------------------------

def s_gate_disabled_by_default_and_cheap(P, d, mp):
    return {"on": P.cluster.enabled(), "coord": P.cluster.coordinator()}


def s_gate_world_one_degrades_to_local(P, d, mp):
    mp.setenv(P.cluster.ENV_VAR, str(d / "kv"))
    return {"on": P.cluster.enabled(), "world": P.cluster.world_size(),
            "coord": P.cluster.coordinator()}


def s_gate_identity_from_env(P, d, mp):
    mp.setenv(P.cluster.RANK_VAR, "3")
    mp.setenv(P.cluster.WORLD_VAR, "5")
    return {"rank": P.cluster.rank(), "world": P.cluster.world_size()}


def s_guarded_step_local_path_never_builds_coordinator(P, d, mp):
    def boom(*a, **k):
        raise AssertionError("Coordinator built on the disabled path")

    mp.setattr(P.consensus, "Coordinator", boom)
    return {"out": P.guard.guarded_step(lambda: 42)}


def s_env_built_coordinator_and_reset(P, d, mp):
    mp.setenv(P.cluster.ENV_VAR, str(d / "kv"))
    mp.setenv(P.cluster.RANK_VAR, "0")
    mp.setenv(P.cluster.WORLD_VAR, "2")
    c = P.cluster.coordinator()
    out = {"rank": c.rank, "world": c.world,
           "cached": P.cluster.coordinator() is c}
    P.cluster.disable()
    out["off"] = P.cluster.coordinator() is None
    P.cluster._reset_for_tests()
    out["again"] = P.cluster.coordinator() is not None
    P.cluster._reset_for_tests()
    return dict(out, kv=["kv"])


# -- rank-addressed fault injection -------------------------------------------

def s_faults_rank_selector_parse(P, d, mp):
    out = []
    for spec in ("hop.exchange:corrupt%rank1@2", "hop.exchange:kill%rank2",
                 "io.write_block:torn%rank0*3@2"):
        (r,) = P.faults.parse(spec)
        out.append([r.point, r.mode, r.rank, r.first, r.times])
    for bad in ("hop.exchange:corrupt%node1", "hop.exchange:corrupt%rank"):
        with pytest.raises(ValueError):
            P.faults.parse(bad)
    return {"rules": out}


def s_faults_rank_selector_addresses_one_rank(P, d, mp):
    mp.setenv(P.cluster.RANK_VAR, "0")
    with P.faults.active("barrier:error%rank1"):
        miss = P.faults.fire("barrier")
        hits = P.faults.hit_count("barrier")
    mp.setenv(P.cluster.RANK_VAR, "1")
    with P.faults.active("barrier:error%rank1"):
        with pytest.raises(P.InjectedFault):
            P.faults.fire("barrier")
    return {"miss": miss, "hits": hits}


def s_faults_unselected_rules_unchanged(P, d, mp):
    (r,) = P.faults.parse("io.open:error*2@3")
    return {"rank": r.rank}


# -- recovery epochs ----------------------------------------------------------

def s_epoch_monotonic_and_journaled(P, d, mp):
    P.obs.enable(str(d / "obs"))
    seq = [P.epoch.current(), P.epoch.advance("test"),
           P.epoch.set_current(5, "jump"),
           P.epoch.set_current(3, "rewind-ignored")]
    events = P.obs.read_journal(str(d / "obs"))
    assert P.obs.lint_journal(events) == []
    P.obs.disable()
    return {"seq": seq, "journaled": [e["epoch"] for e in events
                                      if e["ev"] == "guard.epoch"]}


def s_epoch_stamped_into_checkpoint_manifest(P, d, mp):
    truth = np.random.default_rng(8).standard_normal((8, 6, 4))
    _, u = P.mk_state(truth)
    m = P.CheckpointManager(str(d / "ck"), keep=2)
    m.save(1, {"u": u})
    P.epoch.advance("test-advance")
    m.save(2, {"u": u})
    out = []
    for step in (1, 2):
        with open(str(d / "ck" / f"step-{step:08d}" / "MANIFEST.json")) as f:
            out.append(json.load(f)["epoch"])
    return {"epochs": out}


def s_epoch_stamped_into_crash_bundle(P, d, mp):
    P.guard.enable(str(d / "bundles"))
    P.epoch.set_current(7, "test")
    path = P.guard.write_crash_bundle("test", "epoch-stamp")
    with open(os.path.join(path, "MANIFEST.json")) as f:
        return {"epoch": json.load(f)["epoch"]}


# -- elastic reformation: leave, membership, reform, rejoin -------------------

def s_merge_leave_action(P, d, mp):
    bye = {"status": "leave", "can_retry": False, "can_restore": False}
    v1 = P.merge_statuses([OK, bye])
    v2 = P.merge_statuses([BAD, bye, OK])
    assert v1["action"] == "leave" and v2["action"] in ("restore", "raise")
    return {"v1": v1, "v2": v2}


def s_graceful_leave_is_typed_not_a_failure(P, d, mp):
    P.obs.enable(str(d / "obs"))
    P.guard.enable(str(d / "bundles"))
    kv = P.FileKV(str(d / "kv"))
    a = P.LeaseBoard(kv, 0, 2, ttl=0.3)
    b = P.LeaseBoard(kv, 1, 2, ttl=0.3)
    a.start()
    b.start()
    a.check_peers()
    b.leave()
    time.sleep(0.9)
    with pytest.raises(P.PeerLeftError) as ei:
        a.check_peers()
    assert not isinstance(ei.value, P.PeerFailureError)
    assert not os.path.exists(str(d / "bundles"))
    counters = P.obs.snapshot()["counters"]
    events = P.obs.read_journal(str(d / "obs"))
    assert P.obs.lint_journal(events) == []
    a.stop()
    P.obs.disable()
    return {"rank": ei.value.rank,
            "failures": [k for k in counters
                         if k.startswith("cluster.peer_failures")],
            "changes": sorted([e["rank"], e["change"]] for e in events
                              if e["ev"] == "cluster.member"),
            "kv": ["kv"]}


def s_live_ranks_excludes_dead_and_left(P, d, mp):
    kv = P.FileKV(str(d / "kv"))
    boards = {r: P.LeaseBoard(kv, r, 3, ttl=0.4) for r in range(3)}
    for b in boards.values():
        b.start()
    time.sleep(0.1)
    before = boards[0].live_ranks()
    boards[1].leave()
    boards[2].stop()
    time.sleep(0.9)
    after = boards[0].live_ranks()
    boards[0].stop()
    return {"before": before, "after": after, "kv": ["kv"]}


def _membership(m):
    return {"gen": m.gen, "members": m.members, "joiners": m.joiners,
            "epoch": m.epoch, "new_rank": m.new_rank,
            "new_world": m.new_world, "namespace": m.namespace}


def s_reform_shrinks_world_and_advances_epoch(P, d, mp):
    P.obs.enable(str(d / "obs"))
    kv = P.FileKV(str(d / "kv"))
    coords = {r: P.Coordinator(kv, r, 3, lease_ttl=0.4, verdict_timeout=20)
              for r in range(3)}
    coords[2].shutdown()
    time.sleep(0.9)
    res = {}
    try:
        res = run_ranks(
            lambda: P.elastic.reform(coords[0], reason="peer-failure",
                                     install=False),
            lambda: P.elastic.reform(coords[1], reason="peer-failure",
                                     install=False))
        ok = {"status": "ok", "can_retry": True, "can_restore": False}
        post = run_ranks(lambda: res[0].coordinator.agree("post", ok),
                         lambda: res[1].coordinator.agree("post", ok))
        assert post[0] == post[1]
        events = P.obs.read_journal(str(d / "obs"))
        assert P.obs.lint_journal(events) == []
        return {"m": [_membership(res[r].membership) for r in (0, 1)],
                "epoch": P.epoch.current(), "post": _verdict(post[0]),
                "stages": sorted(e["stage"] for e in events
                                 if e["ev"] == "cluster.reform"),
                "kv": ["kv"]}
    finally:
        for r in res:
            res[r].coordinator.shutdown()
        for c in coords.values():
            c.shutdown()
        P.obs.disable()


def s_reform_join_grows_world_back(P, d, mp):
    kv = P.FileKV(str(d / "kv"))
    c0 = P.Coordinator(kv, 0, 1, lease_ttl=5.0, verdict_timeout=20)
    out = {}

    def survivor():
        kv.get("pa/join/sspare", 20.0)
        out["r"] = P.elastic.reform(c0, reason="resize", install=False)
        return True

    def joiner():
        out["j"] = P.elastic.request_join(kv, "spare", namespace="pa",
                                          timeout=30)
        return True

    try:
        run_ranks(survivor, joiner)
        ok = {"status": "ok", "can_retry": True, "can_restore": False}
        post = run_ranks(lambda: out["r"].coordinator.agree("post", ok),
                         lambda: out["j"].coordinator.agree("post", ok))
        assert post[0] == post[1]
        return {"m": _membership(out["r"].membership),
                "j": _membership(out["j"].membership),
                "post": _verdict(post[0]),
                "consumed": kv.try_get("pa/join/sspare") is None,
                "kv": ["kv"]}
    finally:
        c0.shutdown()
        for k in out:
            out[k].coordinator.shutdown()


def s_elastic_gate_off_preserves_peer_failure(P, d, mp):
    assert not P.elastic.enabled()
    mp.setattr(P.elastic, "reform",
               lambda *a, **k: pytest.fail("reform() on the disabled path"))
    P.guard.enable(str(d / "bundles"))
    kv = P.FileKV(str(d / "kv"))
    c0 = P.Coordinator(kv, 0, 2, lease_ttl=0.3, verdict_timeout=20)
    time.sleep(0.8)
    c0.leases.join_grace = 0.5
    try:
        with pytest.raises(P.PeerFailureError) as ei:
            P.guard.elastic_step(lambda: 1, label="off",
                                 retry=P.RetryPolicy(max_attempts=1),
                                 coordinator=c0)
        return {"rank": ei.value.rank}
    finally:
        c0.shutdown()


def s_elastic_step_reforms_restores_and_reruns(P, d, mp):
    truth = np.random.default_rng(9).standard_normal((11, 9, 13))
    pen, u1 = P.mk_state(truth)
    pen2 = P.pencil_like(pen, (0,))
    P.obs.enable(str(d / "obs"))
    P.guard.enable(str(d / "bundles"))
    P.elastic.enable()
    kv = P.FileKV(str(d / "kv"))
    c0 = P.Coordinator(kv, 0, 2, lease_ttl=0.4, verdict_timeout=20)
    c1 = P.Coordinator(kv, 1, 2, lease_ttl=0.4, verdict_timeout=20)
    mgr = P.CheckpointManager(str(d / "ck"), keep=4)
    mgr.save(1, {"u": u1})
    state = {"u": P.mk_state(truth + 1000.0)[1]}

    def restore_cb(ckpt):
        state["u"] = ckpt.read("u", pen, verify="local")

    c1.shutdown()
    time.sleep(0.9)
    try:
        out = P.guard.elastic_step(
            lambda: P.transpose(state["u"], pen2),
            ckpt_mgr=mgr, restore=restore_cb,
            retry=P.RetryPolicy(max_attempts=2, base_delay=0.01),
            label="elastic", coordinator=c0)
        assert np.array_equal(P.gather(out), truth)
        events = P.obs.read_journal(str(d / "obs"))
        assert P.obs.lint_journal(events) == []
        return {"stages": [e["stage"] for e in events
                           if e["ev"] == "cluster.reform"],
                "recover": [[e["stage"], e.get("via")] for e in events
                            if e["ev"] == "guard.recover"],
                "reforms": P.obs.snapshot()["counters"].get(
                    "cluster.reforms{outcome=ok}"),
                "kv": ["kv"]}
    finally:
        P.cluster._reset_for_tests()
        P.obs.disable()


def s_plan_registry_rebuilt_on_reform(P, d, mp):
    truth = np.random.default_rng(10).standard_normal((8, 6, 4))
    pen, u = P.mk_state(truth)
    pen2 = P.pencil_like(pen, (0,))
    P.gather(P.transpose(u, pen2))
    built = []

    def factory(ctx):
        built.append((ctx.membership.new_world, ctx.coordinator))
        return ("plan-for", ctx.membership.new_world)

    P.elastic.register_plan("fft-main", factory)
    kv = P.FileKV(str(d / "kv"))
    c0 = P.Coordinator(kv, 0, 2, lease_ttl=0.4, verdict_timeout=20)
    c1 = P.Coordinator(kv, 1, 2, lease_ttl=0.4, verdict_timeout=20)
    c1.leave()
    time.sleep(0.9)
    r = None
    try:
        r = P.elastic.reform(c0, reason="leave", install=False)
        assert built[0][1] is r.coordinator
        return {"built": [b[0] for b in built],
                "plan": list(P.elastic.plan("fft-main")),
                "cache": P.compiled_cache.cache_info().currsize,
                "kv": ["kv"]}
    finally:
        c0.shutdown()
        if r is not None:
            r.coordinator.shutdown()


def s_reform_runs_under_hang_watchdog(P, d, mp):
    P.guard.enable(str(d / "bundles"))
    mp.setenv(P.guard.TIMEOUT_VAR, "1.0")
    kv = P.FileKV(str(d / "kv"))
    c0 = P.Coordinator(kv, 0, 1, lease_ttl=5.0, verdict_timeout=20)
    try:
        with pytest.raises(P.HangTimeoutError) as ei:
            P.elastic.reform(c0, reason="wedged", install=False,
                             rebuild=lambda ctx: time.sleep(30))
        assert ei.value.bundle and os.path.isdir(ei.value.bundle)
        return {"typed": True}
    finally:
        c0.shutdown()


def s_min_world_floor_is_enforced(P, d, mp):
    mp.setenv(P.elastic.MIN_WORLD_VAR, "2")
    kv = P.FileKV(str(d / "kv"))
    c0 = P.Coordinator(kv, 0, 2, lease_ttl=0.3, verdict_timeout=20)
    time.sleep(0.7)
    try:
        with pytest.raises(P.ReformError, match="MIN_WORLD"):
            P.elastic.reform(c0, reason="peer-failure", install=False)
        return {"typed": True}
    finally:
        c0.shutdown()


def s_reset_clears_elastic_state(P, d, mp):
    P.elastic.enable()
    P.elastic.register_plan("x", lambda ctx: 1)
    P.elastic._note_gen(7)
    P.cluster._reset_for_tests()
    return {"on": P.elastic.enabled(), "plans": P.elastic.plans(),
            "gen": P.elastic._gen}


def s_announce_leave_at_step_boundary(P, d, mp):
    P.guard.enable(str(d / "bundles"))
    c0, c1 = _pair(P, d, ttl=30.0)
    out = {}

    def survivor():
        t0 = time.monotonic()
        with pytest.raises(P.PeerLeftError) as ei:
            P.guard.guarded_step(lambda: "survivor",
                                 retry=P.RetryPolicy(max_attempts=1),
                                 label="drain", coordinator=c0)
        out["rank"] = ei.value.rank
        assert time.monotonic() - t0 < 20.0
        return True

    def leaver():
        c1.announce_leave()
        out["leaver"] = P.guard.guarded_step(
            lambda: "last-step", retry=P.RetryPolicy(max_attempts=1),
            label="drain", coordinator=c1)
        c1.leave()
        return True

    try:
        assert run_ranks(survivor, leaver) == {0: True, 1: True}
        assert not os.path.exists(str(d / "bundles"))
        return dict(out, kv=["kv"])
    finally:
        c0.shutdown()
        c1.shutdown()


def s_failed_reform_leaves_old_coordinator_alive(P, d, mp):
    kv = P.FileKV(str(d / "kv"))
    c0 = P.Coordinator(kv, 0, 1, lease_ttl=0.4, verdict_timeout=20)

    def boom(ctx):
        raise RuntimeError("replan exploded")

    try:
        with pytest.raises(RuntimeError, match="replan exploded"):
            P.elastic.reform(c0, reason="x", install=False, rebuild=boom)
        time.sleep(0.9)
        age = c0.leases.peer_age(0)
        assert age is not None and age <= 0.4
        raw = kv.try_get("pa.g1/lease/r0")
        if raw is not None:
            time.sleep(0.9)
            assert float(json.loads(kv.try_get("pa.g1/lease/r0"))["t"]) \
                == float(json.loads(raw)["t"])
        return {"alive": True}
    finally:
        c0.shutdown()


SCENARIOS = sorted(n[2:] for n, f in list(globals().items())
                   if n.startswith("s_") and callable(f))


@pytest.mark.parametrize("name", SCENARIOS)
def test_cluster_matches_jax(name, tmp_path, monkeypatch):
    """One case of the JAX package's ``test_cluster.py`` through both
    packages: the same outcomes, KV keys and ``cluster.*`` records."""
    run_both(globals()["s_" + name], tmp_path, monkeypatch)


def test_every_jax_cluster_case_has_a_scenario():
    with open(os.path.join(REPO, "tests", "test_cluster.py")) as f:
        src = f.read()
    jax_cases = sorted(re.findall(r"^def test_(\w+)\(", src, re.M))
    assert len(jax_cases) == 48
    assert jax_cases == SCENARIOS


# -- a mixed mesh: a JAX coordinator and a port coordinator on one FileKV -----

def test_mixed_jax_and_port_mesh(tmp_path, monkeypatch):
    """Rank 0 is the JAX package's Coordinator, rank 1 the port's, on one
    FileKV: they agree on one verdict, elect one checkpoint step and reform
    together — the wire format is JAX's."""
    J, T = par.pkg("jax"), par.pkg("torch")
    for var in par.ENV_VARS:
        monkeypatch.delenv(var, raising=False)
    for P in (J, T):
        P.reset()
    kvdir = str(tmp_path / "kv")
    c0 = J.Coordinator(J.FileKV(kvdir), 0, 3, lease_ttl=0.6,
                       verdict_timeout=30)
    c1 = T.Coordinator(T.FileKV(kvdir), 1, 3, lease_ttl=0.6,
                       verdict_timeout=30)
    c2 = T.Coordinator(T.FileKV(kvdir), 2, 3, lease_ttl=0.6,
                       verdict_timeout=30)
    res = {}
    try:
        v = run_ranks(lambda: c0.agree("mixed", OK),
                      lambda: c1.agree("mixed", BAD),
                      lambda: c2.agree("mixed", OK))
        assert v[0] == v[1] == v[2] and v[0]["action"] == "retry"
        steps = run_ranks(lambda: c0.agree_steps("ck", [1, 2, 3]),
                          lambda: c1.agree_steps("ck", [2, 3]),
                          lambda: c2.agree_steps("ck", [1, 3, 4]))
        assert steps[0] == steps[1] == steps[2] == [3]
        c2.shutdown()                          # rank 2 dies
        time.sleep(1.5)
        res = run_ranks(
            lambda: J.elastic.reform(c0, reason="peer-failure",
                                     install=False),
            lambda: T.elastic.reform(c1, reason="peer-failure",
                                     install=False))
        m0, m1 = res[0].membership, res[1].membership
        assert (m0.members, m0.gen, m0.epoch, m0.namespace) == \
            (m1.members, m1.gen, m1.epoch, m1.namespace) == \
            ([0, 1], 1, 2, "pa.g1")
        assert (m0.new_rank, m1.new_rank) == (0, 1)
        post = run_ranks(lambda: res[0].coordinator.agree("post", OK),
                         lambda: res[1].coordinator.agree("post", OK))
        assert post[0] == post[1] and post[0]["action"] == "ok"
        assert json.loads(T.FileKV(kvdir).try_get("pa/fence")) == \
            {"gen": 1, "epoch": 2}
    finally:
        for r in res.values():
            r.coordinator.shutdown()
        for c in (c0, c1, c2):
            c.shutdown()
        for P in (J, T):
            P.reset()


# -- StoreKV over torch.distributed stores ------------------------------------

def _store_kv_case(kv):
    """The FileKV contract on a store: set/get/delete, set_if's create,
    swap and reject, typed timeouts, one-level listing."""
    from pencilarrays_tpu_torch.cluster.errors import ConsensusTimeoutError

    assert kv.try_get("pa/a/r0") is None
    kv.set("pa/a/r0", "hello")
    assert kv.try_get("pa/a/r0") == "hello"
    assert kv.get("pa/a/r0", 2.0) == "hello"
    kv.set("pa/a/r0", "v2")
    assert kv.try_get("pa/a/r0") == "v2"
    assert kv.set_if("pa/fence", "v1", None) is True
    assert kv.set_if("pa/fence", "v1b", None) is False
    assert kv.set_if("pa/fence", "v2", "stale") is False
    assert kv.set_if("pa/fence", "v2", "v1") is True
    assert kv.try_get("pa/fence") == "v2"
    assert kv.set_if("pa/none", "x", "y") is False
    assert kv.try_get("pa/none") is None
    kv.set("pa/join/s1", "j1")
    kv.set("pa/join/s2", "j2")
    kv.set("pa/join/deep/s3", "j3")
    listed = kv.list_dir("pa/join")
    if listed:                                 # stores without list_keys
        assert listed == {"pa/join/s1": "j1", "pa/join/s2": "j2"}
    kv.delete("pa/a/r0")
    kv.delete("pa/a/r0")
    assert kv.try_get("pa/a/r0") is None
    t0 = time.monotonic()
    with pytest.raises(ConsensusTimeoutError):
        kv.get("pa/never", 0.3)
    assert time.monotonic() - t0 < 5.0
    calls = []

    def late():
        calls.append(1)
        if len(calls) == 2:
            kv.set("pa/late", "now")

    assert kv.get("pa/late", 10.0, on_wait=late) == "now"


def _store(backend, tmp_path):
    from datetime import timedelta

    import torch.distributed as tdist

    if backend == "tcp":
        return tdist.TCPStore("localhost", 0, 1, True,
                              timeout=timedelta(seconds=30))
    return tdist.FileStore(str(tmp_path / "store"), 1)


def _store_pair_agree(store):
    """A coordinator pair agreeing over ``store`` (the store is the wire):
    one ``retry`` verdict, which advances the recovery epoch; the port's
    cluster state (the epoch with it) is reset after, as ``run_both``
    resets it after each scenario."""
    from pencilarrays_tpu_torch import cluster
    from pencilarrays_tpu_torch.cluster.consensus import Coordinator
    from pencilarrays_tpu_torch.cluster.kv import StoreKV

    c0 = Coordinator(StoreKV(store), 0, 2, lease_ttl=10.0,
                     verdict_timeout=30.0)
    c1 = Coordinator(StoreKV(store), 1, 2, lease_ttl=10.0,
                     verdict_timeout=30.0)
    try:
        return run_ranks(lambda: c0.agree("s", OK),
                         lambda: c1.agree("s", BAD))
    finally:
        c0.shutdown()
        c1.shutdown()
        cluster._reset_for_tests()


@pytest.mark.parametrize("backend", ["tcp", "file"])
def test_store_kv_over_a_store(backend, tmp_path):
    from pencilarrays_tpu_torch.cluster.kv import JaxKV, StoreKV

    assert JaxKV is StoreKV
    store = _store(backend, tmp_path)
    _store_kv_case(StoreKV(store))
    v = _store_pair_agree(store)
    assert v[0] == v[1] and v[0]["action"] == "retry"
    assert v[0]["epoch"] >= 1


def test_store_pair_leaves_the_epoch_at_zero(tmp_path):
    """The agreed verdict of a coordinator pair advances the epoch; after
    the pair's reset nothing of it stays in this process: the journal's
    correlation stamp reads epoch 0 again."""
    from pencilarrays_tpu_torch.obs import correlate

    v = _store_pair_agree(_store("file", tmp_path))
    assert v[0]["action"] == "retry" and v[0]["epoch"] >= 1
    assert correlate.stamp()["epoch"] == 0


def test_store_kv_on_the_pools_default_store():
    """``resolve_kv("1")`` on every rank of the shared gloo pool: the
    default group's store is the wire, and the ranks agree over it."""
    import torch_rank_tasks as tasks

    ns = f"pa-store-{os.getpid()}-{time.monotonic_ns()}"
    out = tasks.shared_pool().run(tasks.store_kv_case, ns)
    assert len(out) == 8 and len({json.dumps(o) for o in out}) == 1, out
    assert out[0]["action"] == "retry" and out[0]["ranks"] == [3]
    assert out[0]["steps"] == [1, 2]


# -- subprocess drills (the JAX package's test_multiprocess.py phases) --------

def _launch(tmp_path, world, phase, *, expect_kill_rank=None, n=16,
            timeout=120):
    env = dict(os.environ)
    for var in par.ENV_VARS + ("PENCILARRAYS_TPU_FAULTS_DELAY_S",):
        env.pop(var, None)
    env["PYTHONPATH"] = REPO
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(tmp_path / "kv"), str(world), str(r),
         str(tmp_path), phase, str(n), "cpu"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"cluster {phase} workers timed out (a coordination "
                    f"deadlock); output so far: {outs}")
    for r, (p, out) in enumerate(zip(procs, outs)):
        if r == expect_kill_rank:
            assert p.returncode == -signal.SIGKILL, (r, p.returncode,
                                                     out[-3000:])
            continue
        assert p.returncode == 0, (r, out[-3000:])
        assert f"CLUSTER_OK phase={phase} rank={r}" in out, out[-2000:]
    return outs


def _events(tmp_path):
    from pencilarrays_tpu_torch import obs

    events = obs.read_journal(str(tmp_path / "obs"))
    assert obs.lint_journal(events) == []
    return events


def _cluster_sequence(tmp_path, world):
    victim = max(0, world - 2)
    _launch(tmp_path, world, "sdc")
    events = _events(tmp_path)
    actions = {r: [e["action"] for e in events
                   if e["ev"] == "cluster.verdict" and e["proc"] == r]
               for r in range(world)}
    assert all(a == ["retry", "restore", "elect", "ok"]
               for a in actions.values()), actions
    for r in range(world):
        assert {e["step"] for e in events if e["ev"] == "ckpt.restore"
                and e["proc"] == r} == {1}
    sdc = [e for e in events if e["ev"] == "guard.sdc"]
    assert sdc and all(e["proc"] == 1 for e in sdc), sdc
    outs = _launch(tmp_path, world, "kill", expect_kill_rank=victim)
    for r, out in enumerate(outs):
        if r != victim:
            m = re.search(r"peerfail=(\d+) detect_s=([0-9.]+)", out)
            assert m and int(m.group(1)) == victim, out[-2000:]
            assert float(m.group(2)) < 20.0, out[-2000:]
    events = _events(tmp_path)
    kills = [e for e in events if e["ev"] == "fault" and e["mode"] == "kill"]
    assert kills and all(e["proc"] == victim for e in kills), kills
    for r in range(world):
        if r != victim:
            assert [e for e in events if e["ev"] == "cluster.lease"
                    and e["proc"] == r and e["status"] == "expired"
                    and e["rank"] == victim], r
    _launch(tmp_path, world, "restore")


@pytest.mark.chaos
def test_cluster_coordinated_recovery(tmp_path):
    """2 ranks at 16^3: SDC on rank 1 -> agreed retry -> agreed restore of
    step 1 (rank 0's step 2 is torn) -> bit-identical rerun; rank 0
    SIGKILLed mid-step -> typed PeerFailureError on the survivor within
    the lease deadline; fresh processes elect and restore step 1."""
    _cluster_sequence(tmp_path, 2)


@pytest.mark.slow
@pytest.mark.chaos
def test_cluster_coordinated_recovery_4proc(tmp_path):
    _cluster_sequence(tmp_path, 4)


def _final(out):
    m = re.search(r"FINAL=([0-9a-f]{64})", out)
    assert m, out[-2000:]
    return m.group(1)


def _elastic_sequence(tmp_path, world, n=16):
    victim = world - 1
    ref, el = tmp_path / "ref", tmp_path / "el"
    ref.mkdir()
    el.mkdir()
    finals = {_final(o) for o in _launch(ref, world, "elastic_ref", n=n)}
    assert len(finals) == 1, finals
    outs = _launch(el, world, "elastic", expect_kill_rank=victim, n=n)
    for r, out in enumerate(outs):
        if r == victim:
            continue
        assert _final(out) == next(iter(finals)), out[-2000:]
        # the served plan rode the reformation: both queued requests
        # drained bit-identically on the rebuilt plan
        assert "SERVE_RESUMED=2" in out, out[-2000:]
        rep = json.loads(re.search(r"REFORMED (\{.*\})", out).group(1))
        assert rep["world"] == world - 1 and rep["restored_step"] == 2
        assert rep["members"] == list(range(world - 1))
    events = _events(el)
    for r in range(world - 1):
        mine = [e for e in events if e.get("proc") == r]
        stages = [e["stage"] for e in mine if e["ev"] == "cluster.reform"]
        assert stages.count("begin") == 1 and stages.count("complete") == 1
        assert {e["step"] for e in mine if e["ev"] == "ckpt.restore"} == {2}
        assert {e["step"] for e in mine if e["ev"] == "ckpt.commit"} == \
            {0, 1, 2, 3, 4}
        rec = [(e["stage"], e.get("via")) for e in mine
               if e["ev"] == "guard.recover"]
        assert ("recovered", "reform") in rec, rec
    return next(iter(finals))


@pytest.mark.chaos
def test_elastic_reformation_survives_rank_loss(tmp_path):
    """2 ranks at 16^3: rank 1 SIGKILLed mid-step 3 -> rank 0 reforms to
    world 1, restores the agreed step 2 and finishes bit-identical to the
    uninterrupted run, whose state matches the JAX package's NS state
    after the same 4 steps (round trips are pure movement)."""
    _elastic_sequence(tmp_path, 2)
    _ns_against_jax(tmp_path, n=16, steps=4)


@pytest.mark.slow
@pytest.mark.chaos
def test_elastic_reformation_4rank(tmp_path):
    _elastic_sequence(tmp_path, 4)


def _ns_against_jax(tmp_path, n, steps):
    """The worker's uninterrupted state (its step-4 checkpoint, read on
    the CPU) against the JAX package's NS model after the same steps,
    within test_torch_spectral.py's 1e-4 of the state's max."""
    import jax
    import torch

    import pencilarrays_tpu as jpa
    import pencilarrays_tpu_torch as pat
    from pencilarrays_tpu import models as jmodels
    from pencilarrays_tpu_torch import models
    from pencilarrays_tpu_torch.resilience import CheckpointManager

    topo = pat.Topology((1, 1), device="cpu")
    m = models.NavierStokesSpectral(topo, n, viscosity=1e-2,
                                    dtype=torch.float32)
    got = CheckpointManager(str(tmp_path / "ref" / "ck-elastic_ref.r0")) \
        .restore(steps).read("u", m.plan.output_pencil)
    got = np.asarray(pat.gather(got))
    jm = jmodels.NavierStokesSpectral(
        jpa.Topology((1, 1), devices=jax.devices()[:1]), n, viscosity=1e-2)
    uh = jmodels.taylor_green(jm)
    for _ in range(steps):
        uh = jm.step(uh, 5e-3)
    want = np.asarray(jpa.gather(uh))
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= 1e-4, err


@pytest.mark.chaos
def test_serve_storm_survives_rank_loss(tmp_path):
    """2 ranks at 16^3: each rank's service sheds its 4 sheddable
    reshards typed at submit; rank 1 is SIGKILLed inside the storm batch
    and rank 0's serve dispatch reforms to world 1 and drains: every
    protected ticket resolves once, bit-identical to ``reshard``."""
    outs = _launch(tmp_path, 2, "storm", expect_kill_rank=1)
    out = outs[0]
    assert "STORM_SHED=4" in out, out[-2000:]
    rep = json.loads(re.search(r"STORM_OK=(\{.*\})", out).group(1))
    assert rep["protected"] == 4 and rep["world"] == 1, rep
    events = _events(tmp_path)
    mine = [e for e in events if e.get("proc") == 0]
    assert [e for e in mine if e["ev"] == "serve.pressure"]
    stages = [e["stage"] for e in mine if e["ev"] == "cluster.reform"]
    assert stages.count("complete") == 1, stages
    done = [e for e in mine if e["ev"] == "serve.complete"]
    assert sorted(e["outcome"] for e in done) == ["ok"] * 5


@pytest.mark.chaos
def test_serve_autoscaler_scale_down_and_up(tmp_path):
    """2 ranks at 16^3: both controllers decide ``down`` on idle windows,
    rank 1 leaves by ``announce_leave`` and rank 0 reforms to world 1;
    rank 1 rejoins pre-warmed (``join_prewarmed``), admitted by rank 0's
    overload-driven scale-up; both close with an aligned step."""
    outs = _launch(tmp_path, 2, "scale")
    assert "SCALE_DOWN world=1" in outs[0], outs[0][-2000:]
    assert re.search(r"SCALE_UP gen=\d+ detail=admitted=", outs[0]), \
        outs[0][-2000:]
    assert re.search(r"SCALE_JOINED gen=\d+ rank=1 warm_s=", outs[1]), \
        outs[1][-2000:]
    events = _events(tmp_path)
    scale = [(e["proc"], e["direction"], e["acted"]) for e in events
             if e["ev"] == "serve.scale" and e["reason"] != "prewarm"]
    assert (0, "down", False) in scale and (1, "down", True) in scale
    assert (0, "up", True) in scale, scale


@pytest.mark.chaos
def test_cluster_straggler_detection(tmp_path):
    """rank 1 dragged 0.3 s an exchange: exactly one cluster.straggler
    naming it, from rank 0's fold; the undelayed control: none."""
    straggle, control = tmp_path / "straggle", tmp_path / "control"
    straggle.mkdir()
    control.mkdir()
    _launch(straggle, 2, "straggle")
    events = _events(straggle)
    flags = [e for e in events if e["ev"] == "cluster.straggler"]
    assert len(flags) == 1, flags
    assert flags[0]["rank"] == 1 and flags[0]["proc"] == 0, flags
    assert flags[0]["excess_s"] > 0.1
    with open(str(straggle / "obs" / "mesh_metrics.json")) as f:
        fold = json.load(f)
    assert fold["missing_ranks"] == [] and fold["ranks"] == [0, 1]
    _launch(control, 2, "control")
    events = _events(control)
    assert [e for e in events if e["ev"] == "cluster.straggler"] == []


def test_distributed_helpers_the_cluster_layer_needs(monkeypatch):
    """``kv_client``, ``ensure_initialized``, ``is_initialized`` and
    ``local_devices`` (the JAX package's ``parallel/distributed.py``):
    reading never initializes, and an argument-less bootstrap outside a
    launcher is a no-op."""
    import torch
    import torch.distributed as tdist

    from pencilarrays_tpu_torch.parallel import distributed

    monkeypatch.setattr(tdist, "is_initialized", lambda: False)
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "TORCHELASTIC_RUN_ID"):
        monkeypatch.delenv(var, raising=False)
    assert not distributed.is_initialized()
    assert distributed.kv_client() is None
    assert distributed.ensure_initialized() is False
    assert distributed.ensure_initialized(world_size=1) is False
    monkeypatch.setenv("WORLD_SIZE", "4")
    assert distributed.ensure_initialized() is False   # no launcher marker
    if not torch.cuda.is_available():
        assert distributed.local_devices() == [torch.device("cpu")]
    calls = []
    monkeypatch.setattr(distributed, "initialize",
                        lambda *a, **k: calls.append((a, k)))
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("RANK", "2")
    assert distributed.ensure_initialized() is True
    assert calls == [((None,), {"init_method": "env://", "world_size": 4,
                                "rank": 2})]
    from pencilarrays_tpu_torch.cluster.kv import resolve_kv

    with pytest.raises(RuntimeError, match="no torch.distributed store"):
        resolve_kv("on")
