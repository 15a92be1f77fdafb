"""Worker for the port's coordinated mesh-recovery drills (the JAX
package's ``tests/cluster_worker.py``, ported).

N plain OS processes, each a one-rank ``torch.distributed`` world of its
own on a ``(1, 1)`` topology (its hops make the one-rank exchange), joined
ONLY through a shared ``FileKV`` directory: the drill exercises status
consensus, checkpoint election, health leases, epochs and elastic
reformation, the machinery that behaves the same over a
``torch.distributed`` store.

The drill step is one Navier-Stokes RK2 step at ``n``^3 f32 followed by an
x -> y -> x ``transpose`` round trip of the state (pure data movement: the
bits are the step's).  On a ``(1, 1)`` topology the NS step makes no hop,
so the round trip is what lets ``hop.exchange:*%rank<k>`` rules fire
mid-step, two hits a step.

Phases (each gets a fresh KV namespace):

* ``sdc`` — every rank commits steps 1 (the initial state) and 2 (a
  diverged one); rank 0's step-2 data file is torn.  A guarded step whose
  exchange is corrupted on rank 1 only (``hop.exchange:corrupt%rank1*2``)
  must give an agreed retry, then an agreed restore of step **1** (the
  newest step valid on every rank), and a rerun bit-identical to the
  uninterrupted step.
* ``kill`` — every rank commits step 1, then rank ``max(0, world - 2)`` is
  SIGKILLed at its first exchange; survivors raise a typed
  ``PeerFailureError`` naming it, with a crash bundle, within the lease
  deadline.
* ``restore`` — fresh processes elect ``common_latest_valid()`` (step 1)
  and restore it, bit-identical.
* ``elastic`` / ``elastic_ref`` — 4 checkpointed ``elastic_step``
  iterations; in ``elastic`` rank ``world - 1`` is SIGKILLed at the first
  exchange of step 3.  Survivors detect the loss by lease expiry, reform
  to ``world - 1`` ranks, re-invoke their ``register_plan`` factory (the
  ``n``^3 ``PencilFFTPlan``), restore the agreed step 2, rerun and finish:
  ``FINAL=<sha256>`` must equal the uninterrupted run's.
* ``partition`` — the split-brain drill: the highest rank loses the KV
  wire (``kv.get:partition,kv.set:partition``); it must exit its
  reformation typed ``QuorumLossError``, the majority reforms around it,
  and after the heal its ``FencedKV`` writes are rejected typed.
* ``straggle`` / ``control`` — rank 1 drags every exchange by 0.3 s
  (``hop.exchange:delay%rank1``) or not; rank 0's mesh fold must name
  it exactly once.

Every rank prints ``K1=<launches> <launches by instance>`` (its K1
launches) and ``CLUSTER_OK phase=<phase> rank=<rank>`` at the end.

Usage::

    python torch_cluster_worker.py <kvroot> <world> <rank> <tmpdir> <phase>
        [n] [device]
"""

import hashlib
import json
import os
import sys
import time


def main():
    kvroot, world, rank, tmpdir, phase = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
        sys.argv[5])
    n = int(sys.argv[6]) if len(sys.argv) > 6 else 16
    device = sys.argv[7] if len(sys.argv) > 7 else "cpu"
    # arm the cluster layer before importing the package: identity and
    # gate are env-read, and the journal attributes records to this rank
    os.environ["PENCILARRAYS_TPU_CLUSTER"] = os.path.join(kvroot, phase)
    os.environ["PENCILARRAYS_TPU_CLUSTER_RANK"] = str(rank)
    os.environ["PENCILARRAYS_TPU_CLUSTER_WORLD"] = str(world)
    os.environ.setdefault("PENCILARRAYS_TPU_CLUSTER_LEASE_TTL", "2.0")
    os.environ.setdefault("PENCILARRAYS_TPU_CLUSTER_VERDICT_TIMEOUT", "60")
    os.environ["PENCILARRAYS_TPU_OBS"] = os.path.join(tmpdir, "obs")
    os.environ.setdefault("PENCILARRAYS_TPU_OBS_AGG_S", "0.5")
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import numpy as np
    import torch

    import pencilarrays_tpu_torch as pat
    from pencilarrays_tpu_torch import guard, models
    from pencilarrays_tpu_torch.cluster import PeerFailureError
    from pencilarrays_tpu_torch.ops import permute as k1
    from pencilarrays_tpu_torch.resilience import CheckpointManager, RetryPolicy

    pat.distributed.initialize("nccl" if device == "cuda" else "gloo")
    guard.enable(os.path.join(tmpdir, "bundles", f"r{rank}"))
    topo = pat.Topology((1, 1), device=device)
    model = models.NavierStokesSpectral(topo, n, viscosity=1e-2,
                                        dtype=torch.float32)
    dt = 5e-3
    pen = model.plan.output_pencil
    a, b = pen.decomposition
    alt = pen.replace(decomp_dims=(3 - a - b, b))
    truth = models.taylor_green(model)
    ck = os.path.join(tmpdir, f"ck-{'kill' if phase == 'restore' else phase}"
                              f".r{rank}")
    mgr = CheckpointManager(ck, keep=4)
    victim = max(0, world - 2)          # the rank the kill drill SIGKILLs
    step_ms = []
    stamp = None                        # where the drill step stamps the
                                        # moment before its first hop

    def drill_step(uh):
        t0 = time.perf_counter()
        uh = model.step(uh, dt)
        if stamp is not None:
            if device == "cuda":
                torch.cuda.synchronize()
            with open(stamp, "w") as f:
                f.write(repr(time.time()))
        out = pat.transpose(pat.transpose(uh, alt), pen)
        if device == "cuda":
            torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def bits(x):
        return np.ascontiguousarray(x.data.detach().cpu().numpy()).tobytes()

    def scaled(x, s):
        return pat.PencilArray(x.pencil, x.data * s, x.extra_dims)

    if phase == "sdc":
        ref = bits(drill_step(truth))
        mgr.save(1, {"u": truth})
        mgr.save(2, {"u": scaled(truth, 5.0)})
        if rank == 0:
            # tear rank 0's NEWEST step: rank 1's latest_valid() is still
            # 2, the mesh must agree on 1
            path = os.path.join(ck, "step-00000002", "data.bin")
            with open(path, "r+b") as f:
                f.seek(64)
                c = f.read(1)
                f.seek(64)
                f.write(bytes([c[0] ^ 0xFF]))
        os.environ["PENCILARRAYS_TPU_FAULTS"] = "hop.exchange:corrupt%rank1*2"
        state = {"u": scaled(truth, 1000.0)}

        def restore_cb(ckpt):
            state["u"] = ckpt.read("u", pen)

        t0 = time.perf_counter()
        out = guard.guarded_step(
            lambda: drill_step(state["u"]), ckpt_mgr=mgr,
            restore=restore_cb,
            retry=RetryPolicy(max_attempts=2, base_delay=0.01),
            label="cluster-sdc")
        assert bits(out) == ref, \
            "coordinated recovery is not bit-identical to the step"
        print(f"SDC_RECOVERED step=1 s={time.perf_counter() - t0:.3f}")
    elif phase == "kill":
        mgr.save(1, {"u": truth})
        os.environ["PENCILARRAYS_TPU_FAULTS"] = \
            f"hop.exchange:kill%rank{victim}@1"
        t0 = time.monotonic()
        try:
            guard.guarded_step(lambda: drill_step(truth), ckpt_mgr=mgr,
                               restore=lambda c: None,
                               retry=RetryPolicy(max_attempts=2,
                                                 base_delay=0.01),
                               label="cluster-kill")
        except PeerFailureError as e:
            detect_s = time.monotonic() - t0
            assert e.rank == victim, f"wrong peer named: {e.rank}"
            assert e.bundle and os.path.isdir(e.bundle), \
                f"no crash bundle on PeerFailureError: {e.bundle!r}"
            with open(os.path.join(e.bundle, "MANIFEST.json")) as f:
                assert json.load(f)["reason"] == "peer-failure"
            print(f"CLUSTER_OK phase=kill rank={rank} "
                  f"peerfail={e.rank} detect_s={detect_s:.2f}")
            _report(k1, step_ms)
            return
        raise SystemExit(
            f"rank {rank}: expected SIGKILL (rank {victim}) or "
            f"PeerFailureError (survivors) — got a clean step")
    elif phase == "restore":
        step = mgr.common_latest_valid()
        assert step == 1, f"expected agreed step 1, got {step}"
        back = mgr.restore(step).read("u", pen)
        assert bits(back) == bits(truth), \
            "coordinated restore is not bit-identical"
        print(f"RESTORED step={step}")
    elif phase in ("elastic", "elastic_ref"):
        from pencilarrays_tpu_torch.cluster import elastic

        os.environ["PENCILARRAYS_TPU_ELASTIC"] = "1"
        nsteps, kill_step = 4, 3
        if phase == "elastic":
            # 2 hop.exchange hits a step (the round trip): the victim dies
            # at the first exchange of step kill_step
            os.environ["PENCILARRAYS_TPU_FAULTS"] = (
                f"hop.exchange:kill%rank{world - 1}"
                f"@{2 * (kill_step - 1) + 1}")
            if rank == world - 1:
                stamp = os.path.join(tmpdir, f"prekill.r{rank}")

        def plan_factory(ctx=None):
            return pat.PencilFFTPlan(pat.Topology((1, 1), device=device),
                                     (n, n, n), real=True,
                                     dtype=torch.float32, batch=3)

        elastic.register_plan("ns-fft", plan_factory)
        state = {"u": truth}

        def erestore(ckpt):
            state["u"] = ckpt.read("u", pen, verify="local")

        mgr.save(0, {"u": state["u"]})
        for k in range(1, nsteps + 1):
            out = guard.elastic_step(
                lambda: drill_step(state["u"]), ckpt_mgr=mgr,
                restore=erestore,
                retry=RetryPolicy(max_attempts=2, base_delay=0.01),
                label=f"estep{k}")
            t_end = time.time()
            state["u"] = out
            mgr.save(k, {"u": state["u"]})
            r = elastic.last_reformation()
            if phase == "elastic" and r is not None and k == kill_step:
                with open(os.path.join(tmpdir,
                                       f"prekill.r{world - 1}")) as f:
                    t_kill = float(f.read())
                p = elastic.plan("ns-fft")
                assert p is not None and \
                    p.plan_key() == model.plan.plan_key(), \
                    "reformation did not rebuild the registered plan"
                wall = t_end - t_kill
                print("REFORMED " + json.dumps({
                    "gen": r.membership.gen,
                    "world": r.membership.new_world,
                    "members": r.membership.members,
                    "restored_step": r.restored_step,
                    "timings": r.timings,
                    "kill_to_rerun_end_s": wall,
                    # the rest of that wall time: detection by lease
                    # expiry and the failed verdict round before the
                    # reformation began
                    "detect_s": wall - r.timings["total_s"]
                    - step_ms[-1] / 1e3}))
        if phase == "elastic":
            assert elastic.last_reformation() is not None, \
                "survivor finished without reforming"
        final = hashlib.sha256(bits(state["u"])).hexdigest()
        print(f"FINAL={final}")
    elif phase == "partition":
        from pencilarrays_tpu_torch import cluster
        from pencilarrays_tpu_torch.cluster import (FencedWriteError,
                                                    QuorumLossError, elastic)
        from pencilarrays_tpu_torch.cluster.kv import FencedKV

        os.environ["PENCILARRAYS_TPU_ELASTIC"] = "1"
        coord = cluster.coordinator()
        assert coord is not None, "cluster layer did not arm"
        ok = {"status": "ok", "can_retry": True, "can_restore": False}
        assert coord.agree("pre", ok)["action"] == "ok"
        victim_rank = world - 1
        if rank == victim_rank:
            os.environ["PENCILARRAYS_TPU_FAULTS"] = (
                "kv.get:partition,kv.set:partition")
            t0 = time.monotonic()
            try:
                elastic.reform(coord, reason="partition", install=False,
                               timeout=3.0)
            except QuorumLossError as e:
                print(f"MINORITY_TYPED have={len(e.have)} need={e.need} "
                      f"of={len(e.of)} detect_s={time.monotonic() - t0:.2f}",
                      flush=True)
            else:
                raise SystemExit("minority side formed a rival mesh")
            coord.shutdown()
            os.environ["PENCILARRAYS_TPU_FAULTS"] = ""
            zombie = FencedKV(coord.kv, namespace=coord.ns, generation=0,
                              epoch=0)
            t_wait = time.monotonic() + 120
            while zombie.fence() is None:
                if time.monotonic() >= t_wait:
                    raise SystemExit("majority fence never landed")
                time.sleep(0.1)
            try:
                zombie.set(f"{coord.ns}/poison/r{rank}", "stale")
            except FencedWriteError as e:
                print(f"ZOMBIE_FENCED token={e.token} fence={e.fence}",
                      flush=True)
            else:
                raise SystemExit("zombie write landed in the live namespace")
            assert coord.kv.try_get(f"{coord.ns}/poison/r{rank}") is None
        else:
            t0 = time.monotonic()
            while victim_rank in coord.leases.live_ranks():
                if time.monotonic() - t0 > 60:
                    raise SystemExit("victim lease never went stale")
                time.sleep(0.1)
            r = elastic.reform(coord, reason="partition", install=False,
                               detect_s=time.monotonic() - t0)
            m = r.membership
            assert m.members == list(range(world - 1)), m.members
            post = r.coordinator.agree("post", ok)
            assert post["action"] == "ok", post
            print(f"REFORMED gen={m.gen} world={m.new_world} "
                  f"ns={m.namespace}", flush=True)
            r.coordinator.shutdown()
            coord.shutdown()
    elif phase in ("straggle", "control"):
        from pencilarrays_tpu_torch import cluster

        if phase == "straggle":
            os.environ["PENCILARRAYS_TPU_FAULTS_DELAY_S"] = "0.3"
            os.environ["PENCILARRAYS_TPU_FAULTS"] = "hop.exchange:delay%rank1"
        for _ in range(4):
            guard.guarded_step(lambda: pat.transpose(truth, alt),
                               label="straggle-step")
        coord = cluster.coordinator()
        assert coord is not None and coord.aggregator is not None, \
            "obs+cluster armed but no mesh aggregator"
        agg = coord.aggregator
        assert agg.publish_once(), "snapshot publish failed"
        coord.allgather("straggle-published", {"rank": rank})
        if rank == 0:
            fold = agg.fold_once(wait=True, timeout=60)
            assert fold is not None and not fold["missing_ranks"], fold
    else:
        raise SystemExit(f"unknown phase {phase!r}")
    _report(k1, step_ms)
    print(f"CLUSTER_OK phase={phase} rank={rank}", flush=True)


def _report(k1, step_ms):
    print(f"STEP_MS={json.dumps([round(t, 3) for t in step_ms])}")
    print(f"K1={k1.launches} {json.dumps(dict(k1.launches_by_instance))}",
          flush=True)


if __name__ == "__main__":
    main()
