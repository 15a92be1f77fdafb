"""The partition-tolerant control plane (compare-and-set and fencing on the
KV wire, the quorum gate of membership consensus) held against the JAX
package's.

The 12 KV, fence and quorum cases of the JAX package's
``tests/test_partition.py`` run as scenarios through both packages
(``torch_cluster_parity.run_both``: the same outcomes, KV keys and
``cluster.*`` journal records), and the 3-process split-brain drill of
``tests/test_partition_chaos.py`` runs on the port's worker.  The WAL,
router and lint cases wait for the port's ``fleet/`` and ``analysis/``.
"""

import json
import os
import re
import threading
import time

import pytest

from torch_cluster_parity import run_both, run_ranks

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


def test_every_jax_partition_case_has_a_scenario():
    """The 12 cases of ``test_partition.py`` before its WAL section."""
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "test_partition.py")) as f:
        src = f.read()
    src = src[:src.index("# the router WAL")]
    cases = sorted(re.findall(r"^def test_(\w+)\(", src, re.M))
    assert len(cases) == 12 and cases == SCENARIOS


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
