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
  ``FINAL=<sha256>`` must equal the uninterrupted run's.  A
  ``serve.PlanService`` with a named ``n``^3 r2c plan and two host-payload
  requests queued before the loop rides along: the reformation re-invokes
  its factory, the queue re-binds, and the drain after the loop answers
  both bit-identically to the rebuilt plan's compiled calls
  (``SERVE_RESUMED=2``).
* ``storm`` — the overload drill: each rank's ``PlanService`` (a protected
  tenant with a deadline, a sheddable one; the pressure gate armed) takes
  4 protected ``n``^3 f32 reshards while all 4 sheddable ones are shed
  typed at submit; rank 1 is SIGKILLed at its next exchange, inside the
  storm batch, and the survivor's serve dispatch (``elastic_step``)
  reforms to world 1 and drains: every protected ticket resolves once,
  under its deadline, bit-identical to ``reshard`` (``STORM_OK=4``).
* ``scale`` — the autoscaler's round trip: both ranks' controllers agree
  the mesh is idle, the highest rank ``announce_leave``s and the survivor
  reforms down; the departed process pre-warms an ``n``^3 plan and
  rejoins (``join_prewarmed``), admitted by the survivor's
  overload-driven scale-up reformation; an aligned ``guarded_step`` on
  the grown mesh closes it.
* ``partition`` — the split-brain drill: the highest rank loses the KV
  wire (``kv.get:partition,kv.set:partition``); it must exit its
  reformation typed ``QuorumLossError``, the majority reforms around it,
  and after the heal its ``FencedKV`` writes are rejected typed.
* ``straggle`` / ``control`` — rank 1 drags every exchange by 0.3 s
  (``hop.exchange:delay%rank1``) or not; rank 0's mesh fold must name
  it exactly once.

Every rank prints ``K1=<launches> <launches by instance>`` (its K1
launches), ``K1_CLASSES=<json>`` (the classes it launched, as
``permute.recorded`` keys them, with their counts) and ``CLUSTER_OK
phase=<phase> rank=<rank>`` at the end.

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

    k1.recorded = {}
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
        # the served plan rides the reformation: its requests are queued
        # before the loop and drained after it, across the reformation
        # (the uninterrupted reference run has no reformation to cross)
        from pencilarrays_tpu_torch.serve import PlanService

        def served_plan_factory(ctx=None):
            return pat.PencilFFTPlan(pat.Topology((1, 1), device=device),
                                     (n, n, n), real=True,
                                     dtype=torch.float32)

        svc = None
        if phase == "elastic":
            svc = PlanService(max_batch=4, max_wait_s=60.0)
            svc.register_plan("served-fft", served_plan_factory)
            serve_rng = np.random.default_rng(23)
            serve_payloads = [serve_rng.random((n, n, n), dtype=np.float32)
                              - 0.5 for _ in range(2)]
            serve_tickets = [svc.submit("client", u, name="served-fft")
                             for u in serve_payloads]
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
            sp = elastic.plan("serve:served-fft")
            assert sp is not None and svc.plan("served-fft") is sp, \
                "the service did not re-bind to the rebuilt served plan"
            assert svc.drain() >= 1, "the service had nothing queued"
            cur = svc.plan("served-fft")
            scp = cur.compile(())
            ok = 0
            for u, t in zip(serve_payloads, serve_tickets):
                got = t.result(5)
                ref = scp.forward(pat.PencilArray.from_global(
                    cur.input_pencil, u))
                _served_equal(got, ref, "served request after the "
                                        "reformation")
                ok += 1
            svc.close()
            print(f"SERVE_RESUMED={ok}")
            del svc, scp, serve_tickets
        final = hashlib.sha256(bits(state["u"])).hexdigest()
        print(f"FINAL={final}")
    elif phase == "storm":
        from pencilarrays_tpu_torch.resilience import faults
        from pencilarrays_tpu_torch.serve import (SLO, AdmissionError,
                                                  PlanService,
                                                  PressurePolicy)

        os.environ["PENCILARRAYS_TPU_ELASTIC"] = "1"
        pin = pat.Pencil(topo, (n, n, n), (1, 2))
        pout = pin.replace(decomp_dims=(0, 2))
        svc = PlanService(
            max_batch=4, max_wait_s=60.0,
            slos={"prot": SLO(deadline_s=120.0, shed_priority=10),
                  "bulk": SLO(shed_priority=0)},
            pressure=PressurePolicy(high_water_s=1e-4, low_water_s=5e-5),
            retry=RetryPolicy(max_attempts=2, base_delay=0.01))
        payloads = [np.random.default_rng(100 + i).random(
            (n, n, n), dtype=np.float32) - 0.5 for i in range(4)]

        def field(u):
            return pat.PencilArray.from_global(pin, u)

        # warm-up: one aligned boundary that seeds the service rate
        w = svc.submit_reshard("prot", field(payloads[0]), pout)
        assert svc.drain() == 1
        w.result(120)
        prot = [svc.submit_reshard("prot", field(p), pout)
                for p in payloads]
        shed = 0
        for p in payloads:
            try:
                svc.submit_reshard("bulk", field(p), pout)
            except AdmissionError as e:
                assert e.reason == "shed", e.reason
                shed += 1
        assert shed == 4, f"expected 4 shed, got {shed}"
        print(f"STORM_SHED={shed}")
        k = faults.hit_count("hop.exchange")
        os.environ["PENCILARRAYS_TPU_FAULTS"] = \
            f"hop.exchange:kill%rank1@{k + 1}"
        t0 = time.perf_counter()
        assert svc.drain() >= 1
        drain_s = time.perf_counter() - t0
        digest = hashlib.sha256()
        for p, t in zip(payloads, prot):
            out = t.result(120)
            ref = pat.reshard(field(p), pout)
            assert bits(out) == bits(ref), \
                "protected result differs from unloaded execution"
            assert t.t_done - t.t_submit < 120.0, "deadline busted"
            digest.update(bits(out))
        st = svc.stats()
        assert st["completed"] == {"ok": 5}, st["completed"]
        assert st["slo_violations"] == 0 and \
            st["pressure"] in ("shed", "evict"), st
        from pencilarrays_tpu_torch.cluster import elastic

        r = elastic.last_reformation()
        assert r is not None and r.membership.new_world == world - 1
        svc.close()
        print("STORM_OK=" + json.dumps({
            "protected": len(prot), "drain_s": drain_s,
            "timings": r.timings, "world": r.membership.new_world}))
        print(f"FINAL={digest.hexdigest()}")
    elif phase == "scale":
        from pencilarrays_tpu_torch import cluster
        from pencilarrays_tpu_torch.serve import (SLO, AutoscalePolicy,
                                                  Autoscaler, PlanService)
        from pencilarrays_tpu_torch.serve.autoscale import join_prewarmed

        os.environ["PENCILARRAYS_TPU_ELASTIC"] = "1"
        policy = RetryPolicy(max_attempts=2, base_delay=0.01)
        svc = PlanService(max_batch=4, max_wait_s=60.0,
                          slos={"prot": SLO(shed_priority=1)})
        asc = Autoscaler(svc, policy=AutoscalePolicy(
            overload_drain_s=0.05, windows=2, cooldown_s=0.0, min_world=1))

        def tick_step():
            return pat.transpose(truth, alt)

        asc.tick()
        d = asc.tick()
        assert d.direction == "down", d
        coord = cluster.coordinator()
        if rank == world - 1:
            assert d.acted and coord.leaving, d
            assert guard.guarded_step(tick_step, retry=policy,
                                      label="scale-boundary") is not None
            kv = coord.kv
            coord.leave()
            t_wait = time.monotonic() + 60
            while kv.try_get("pa.g1/lease/r0") is None:
                if time.monotonic() >= t_wait:
                    raise SystemExit("scale-down reformation never landed")
                time.sleep(0.1)

            def factory(ctx=None):
                return pat.PencilFFTPlan(pat.Topology((1, 1), device=device),
                                         (n, n, n), real=True,
                                         dtype=torch.float32)

            r, warm = join_prewarmed(coord.kv, f"s{rank}",
                                     factories={"scale-plan": factory},
                                     timeout=180)
            print(f"SCALE_JOINED gen={r.membership.gen} "
                  f"rank={r.membership.new_rank} "
                  f"warm_s={warm['warm_s']:.3f}")
            assert guard.guarded_step(lambda: "post-join", retry=policy,
                                      label="post-join",
                                      coordinator=r.coordinator) == \
                "post-join"
        else:
            assert not d.acted and d.detail == "not-leaver", d
            assert guard.elastic_step(tick_step, retry=policy,
                                      label="scale-boundary") is not None
            coord = cluster.coordinator()
            assert coord.world == world - 1, coord.world
            print(f"SCALE_DOWN world={coord.world}")
            svc.queue.load.note_completed(1000, 1, 1.0)
            svc.queue.load.note_arrival(10_000)
            deadline_t = time.monotonic() + 120
            acted = None
            while time.monotonic() < deadline_t:
                dd = asc.tick()
                if dd.direction == "up" and dd.acted:
                    acted = dd
                    break
                time.sleep(0.25)
            assert acted is not None, "scale-up never admitted a joiner"
            print(f"SCALE_UP gen={acted.gen} detail={acted.detail}")
            newc = cluster.coordinator()
            assert newc.world == world, newc.world
            assert guard.guarded_step(lambda: "post-join", retry=policy,
                                      label="post-join",
                                      coordinator=newc) == "post-join"
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


def _served_equal(got, ref, what):
    """A served result against the sequential compiled call: bit for bit
    (the CPU, and the card unless the coalesced cuFFT plan rounds apart
    from the single one: then within 1e-6 of the reference's largest
    magnitude, and the difference printed as ``SERVE_CUFFT_DIFF``)."""
    import torch

    a, b = got.data, ref.data
    if torch.equal(a, b):
        return
    err = ((a - b).abs().max() / b.abs().max()).item()
    print(f"SERVE_CUFFT_DIFF {what}: max |diff| / max |ref| = {err:.3e}")
    assert a.is_cuda and err <= 1e-6, f"{what}: not the sequential bits"


def _report(k1, step_ms):
    print(f"STEP_MS={json.dumps([round(t, 3) for t in step_ms])}")
    print(f"K1={k1.launches} {json.dumps(dict(k1.launches_by_instance))}",
          flush=True)
    print("K1_CLASSES=" + json.dumps([[list(_lists(c)), n] for c, n in
                                      (k1.recorded or {}).items()]),
          flush=True)


def _lists(x):
    return [_lists(i) for i in x] if isinstance(x, tuple) else x


if __name__ == "__main__":
    main()
