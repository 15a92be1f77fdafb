"""Serve scenarios written once against :class:`SPkg` (the surface of one
package) and run through the JAX package and through the port.

Imported by the gloo pool's rank processes too (``torch_rank_tasks.
serve_scenario``), so nothing here imports JAX at module level: the JAX
package is imported only when an ``SPkg("jax")`` is built, in the test
process.  A scenario runs the JAX test's body (its assertions included)
and returns what the two packages must agree on: results as NumPy arrays
under ``"fft"`` (held to the FFT parity tolerance) or ``"bits"`` (held
bit for bit), and everything else (outcomes, counters, ``serve.*``
records without their clocks, keys, decisions) under plain keys, held
equal.  On several ranks every rank runs the scenario; arrays are
gathered on every rank.
"""

import importlib
import itertools
import json
import math
import os
import time

import numpy as np


class SPkg:
    """The surface of one package the serve scenarios use.  ``topo`` maps
    dims to a topology (default: the package's own on the CPU)."""

    def __init__(self, which: str, topo=None):
        self.name = which
        if which == "jax":
            import jax

            import pencilarrays_tpu as pa
            from pencilarrays_tpu import cluster, engine, guard, obs, serve
            from pencilarrays_tpu.cluster import elastic
            from pencilarrays_tpu.cluster.consensus import Coordinator
            from pencilarrays_tpu.cluster.kv import FileKV
            from pencilarrays_tpu.engine import errors as eerrors
            from pencilarrays_tpu.guard import IntegrityError
            from pencilarrays_tpu.obs import events, metrics, schema
            from pencilarrays_tpu.obs.__main__ import main as obs_main
            from pencilarrays_tpu.obs import timeline
            from pencilarrays_tpu.parallel import routing
            from pencilarrays_tpu.resilience import (CheckpointManager,
                                                     RetryPolicy, faults)
            from pencilarrays_tpu.resilience.errors import InjectedFault
            from pencilarrays_tpu.serve import autoscale, queue, shed, slo
            from pencilarrays_tpu.serve import precision

            self._default_topo = lambda dims: pa.Topology(
                tuple(dims), devices=jax.devices()[:math.prod(dims)])
            self.dtype = lambda name: np.dtype(name)
            self.gather = lambda x: np.asarray(pa.gather(x))
        else:
            import torch

            import pencilarrays_tpu_torch as pa
            from pencilarrays_tpu_torch import (cluster, engine, guard, obs,
                                                serve)
            from pencilarrays_tpu_torch.cluster import elastic
            from pencilarrays_tpu_torch.cluster.consensus import Coordinator
            from pencilarrays_tpu_torch.cluster.kv import FileKV
            from pencilarrays_tpu_torch.engine import errors as eerrors
            from pencilarrays_tpu_torch.guard import IntegrityError
            from pencilarrays_tpu_torch.obs import events, metrics, schema
            from pencilarrays_tpu_torch.obs.__main__ import main as obs_main
            from pencilarrays_tpu_torch.obs import timeline
            from pencilarrays_tpu_torch.parallel import routing
            from pencilarrays_tpu_torch.resilience import (CheckpointManager,
                                                           RetryPolicy,
                                                           faults)
            from pencilarrays_tpu_torch.resilience.errors import InjectedFault
            from pencilarrays_tpu_torch.serve import (autoscale, queue, shed,
                                                      slo)
            from pencilarrays_tpu_torch.serve import precision

            self._default_topo = lambda dims: pa.Topology(tuple(dims),
                                                          device="cpu")
            self.dtype = lambda name: getattr(torch, name)
            self.gather = lambda x: pa.gather(x, root=None)
        self.pa, self.serve, self.obs, self.guard = pa, serve, obs, guard
        self.cluster, self.elastic, self.engine = cluster, elastic, engine
        self.Coordinator, self.FileKV = Coordinator, FileKV
        self.eerrors, self.IntegrityError = eerrors, IntegrityError
        self.events, self.metrics, self.schema = events, metrics, schema
        self.obs_main, self.timeline, self.routing = obs_main, timeline, \
            routing
        self.CheckpointManager, self.RetryPolicy = CheckpointManager, \
            RetryPolicy
        self.faults, self.InjectedFault = faults, InjectedFault
        self.autoscale, self.queue, self.shed, self.slo = autoscale, queue, \
            shed, slo
        self.precision = precision
        self._topo_fn = topo
        self.PencilFFTPlan = pa.PencilFFTPlan

    def topo(self, dims):
        return (self._topo_fn or self._default_topo)(tuple(dims))

    def plan(self, dims, shape, **kw):
        if "dtype" in kw:
            kw["dtype"] = self.dtype(kw["dtype"])
        return self.pa.PencilFFTPlan(self.topo(dims), shape, **kw)

    def from_global(self, pen, u):
        return self.pa.PencilArray.from_global(pen, u)

    def rank0(self) -> bool:
        if self.name == "jax":
            return True
        import torch.distributed as dist

        return not dist.is_initialized() or dist.get_rank() == 0

    def reset(self):
        """Start (and leave) obs, guard, faults and the cluster layer off
        and reset, as the JAX serve tests' ``_clean`` fixture does."""
        for var in (self.obs.ENV_VAR, self.guard.ENV_VAR,
                    self.faults.ENV_VAR, "PENCILARRAYS_TPU_RETRIES",
                    "PENCILARRAYS_TPU_ELASTIC"):
            os.environ.pop(var, None)
        self.guard._reset_for_tests()
        self.faults.clear()
        self.events._reset_for_tests()
        self.metrics.registry.reset()
        # a solo request's coalesce key counts the process's solo
        # requests so far: the count restarts, so keys compare whatever
        # ran before in the same worker or rank process
        importlib.import_module(
            self.serve.__name__ + ".service")._solo_ids = itertools.count(1)

    def counters(self, prefix=("serve.", "compile.")):
        snap = self.metrics.snapshot()["counters"]
        # the JAX package's jitted-hop cache (cache=hop) has no
        # counterpart: the port compiles nothing per hop
        return {k: v for k, v in sorted(snap.items())
                if k.startswith(prefix) and "cache=hop" not in k}


# -- helpers -------------------------------------------------------------------

def host(rng, shape, real=False):
    if real:
        return rng.standard_normal(shape).astype(np.float32)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


# fields of serve records that differ run to run or package to package
# for reasons that are not behavior: clocks and measured durations,
# process-global request ids and minted trace ids, message texts, and the
# journal's own bookkeeping
VOLATILE = {"t_wall", "t_mono", "run", "seq", "pid", "proc", "host",
            "thread", "trace", "traces", "req", "reqs", "seconds",
            "wait_s", "drain_s", "late_s", "projection", "error", "v",
            "step_idx", "epoch", "plan_fp", "mono", "wall"}


def serve_records(P, directory):
    """The journal's ``serve.*`` records without their volatile fields,
    in journal order, each with its key set."""
    out = []
    for e in P.events.read_journal(directory):
        if not str(e.get("ev", "")).startswith("serve."):
            continue
        stable = {k: v for k, v in sorted(e.items()) if k not in VOLATILE}
        if "chain" in stable:
            # the port chains a mesh's batches on one more resource, so
            # that every rank issues them in take order
            stable["chain"] = stable["chain"].replace("|serve-mesh", "")
        out.append((e["ev"], sorted(e), stable))
    return out


def outcome(t):
    err = t.error()
    if err is None:
        return "ok" if t.done() else "pending"
    return type(err).__name__ + ":" + str(getattr(err, "reason", ""))


# -- plan keys and the registry ------------------------------------------------

def s_plan_key_stable(P, dims):
    a = P.plan(dims, (8, 6, 4), transforms=("rfft", "fft", "fft"))
    b = P.plan(dims, (8, 6, 4), transforms=("rfft", "fft", "fft"))
    assert a.plan_key() == b.plan_key()
    assert len(a.plan_key()) == 12
    c = P.plan(dims, (8, 6, 4), transform="fft")
    assert c.plan_key() != a.plan_key()
    d32 = P.plan((1,), (8, 6), transform="dct", dtype="float32")
    d64 = P.plan((1,), (8, 6), transform="dct", dtype="float64")
    assert d32.plan_key() != d64.plan_key()
    return {"keys": [a.plan_key(), c.plan_key(), d32.plan_key(),
                     d64.plan_key()]}


def s_plan_key_journal(P, dims, d):
    P.obs.enable(str(d))
    plan = P.plan(dims, (8, 6, 4))
    P.obs.disable()
    builds = [e for e in P.events.read_journal(str(d))
              if e["ev"] == "plan.build"]
    assert builds and builds[-1]["plan_fp"] == plan.plan_key()
    return {"key": plan.plan_key()}


def s_reshard_key(P, dims):
    key = P.routing.reshard_key
    src = P.pa.Pencil(P.topo(dims), (8, 6, 4), (1, 2))
    dst = P.pa.Pencil(P.topo(dims), (8, 6, 4), (0, 2))
    f32, c64 = P.dtype("float32"), P.dtype("complex64")
    k1 = key(src, dst, f32)
    src2 = P.pa.Pencil(P.topo(dims), (8, 6, 4), (1, 2))
    assert key(src2, dst, f32) == k1
    assert key(src, dst, c64) != k1
    assert key(dst, src, f32) != k1
    return {"keys": [k1, key(src, dst, c64), key(dst, src, f32)]}


def s_registry_counts(P, dims, d):
    P.obs.enable(str(d))
    p1 = P.plan(dims, (8, 6, 4))
    p2 = P.plan(dims, (8, 6, 4))
    reg = P.serve.PlanRegistry()
    assert reg.register(p1) is p1
    assert reg.register(p2) is p1
    cp = reg.compiled(p1, (), tenants=["alice"])
    assert reg.compiled(p2, (), tenants=["alice", "bob"]) is cp
    st = reg.stats()
    assert (st["hits"], st["misses"]) == (1, 1)
    first = P.counters()
    assert not any("cache=plan" in k for k in first)
    p1.compile(())
    second = P.counters()
    assert second["compile.cache_hits{cache=plan}"] == 1
    P.obs.disable()
    return {"stats": st, "counters": [first, second]}


def s_registry_replace(P, dims):
    p1 = P.plan(dims, (8, 6, 4))
    reg = P.serve.PlanRegistry()
    reg.register(p1)
    reg.compiled(p1, ())
    assert reg.stats()["executables"] == 1
    p2 = P.plan(dims, (8, 6, 4))
    assert reg.register(p2, replace=True) is p2
    assert reg.stats()["executables"] == 0
    return {"stats": reg.stats()}


# -- coalescing ----------------------------------------------------------------

def s_coalesced_equals_sequential(P, dims, real, direction):
    plan = P.plan(dims, (8, 6, 4), real=real)
    rng = np.random.default_rng(7)
    if direction == "forward":
        us = [host(rng, plan.shape_physical, real=real) for _ in range(5)]
    else:
        cp0 = plan.compile(())
        us = [P.gather(cp0.forward(P.from_global(
            plan.input_pencil, host(rng, plan.shape_physical, real=real))))
            for _ in range(5)]
    svc = P.serve.PlanService(max_batch=4, max_wait_s=0.0)
    tickets = [svc.submit("t0" if i % 2 else "t1", u, plan=plan,
                          direction=direction) for i, u in enumerate(us)]
    assert svc.drain() == 2
    cp = plan.compile(())
    pen = plan.input_pencil if direction == "forward" else \
        plan.output_pencil
    got, seq = [], []
    for u, t in zip(us, tickets):
        x = P.from_global(pen, u.astype(us[0].dtype))
        ref = cp.forward(x) if direction == "forward" else cp.backward(x)
        g, r = P.gather(t.result(5)), P.gather(ref)
        assert np.array_equal(g, r), \
            "coalesced dispatch is not bit-identical to sequential"
        got.append(g)
        seq.append(r)
    st = svc.stats()
    assert st["completed"] == {"ok": 5} and st["dispatches"] == 2
    return {"fft": {"served": np.stack(got)}, "completed": st["completed"],
            "dispatches": st["dispatches"], "registry": st["registry"]}


def s_device_payloads_cache_reuse(P, dims):
    plan = P.plan(dims, (8, 6, 4))
    rng = np.random.default_rng(3)
    svc = P.serve.PlanService(max_batch=2, max_wait_s=0.0)
    got = []
    for wave in range(2):
        us = [P.from_global(plan.input_pencil, host(rng, plan.shape_physical))
              for _ in range(2)]
        ts = [svc.submit("t", u, plan=plan) for u in us]
        svc.drain()
        cp = plan.compile(())
        for u, t in zip(us, ts):
            g = P.gather(t.result(5))
            assert np.array_equal(g, P.gather(cp.forward(u)))
            got.append(g)
    st = svc.stats()["registry"]
    assert st["misses"] == 1 and st["hits"] == 1
    return {"fft": {"served": np.stack(got)}, "registry": st}


def s_reshard_coalesce(P, dims):
    src = P.pa.Pencil(P.topo(dims), (8, 6, 4), (1, 2))
    dst = P.pa.Pencil(P.topo(dims), (8, 6, 4), (0, 2))
    rng = np.random.default_rng(5)
    us = [P.from_global(src, host(rng, (8, 6, 4))) for _ in range(3)]
    svc = P.serve.PlanService(max_batch=4, max_wait_s=0.0)
    ts = [svc.submit_reshard("t", u, dst) for u in us]
    assert svc.drain() == 1
    got = []
    for u, t in zip(us, ts):
        out = t.result(5)
        assert out.pencil == dst
        g = P.gather(out)
        assert np.array_equal(g, P.gather(P.pa.reshard(u, dst)))
        got.append(g)
    return {"bits": {"served": np.stack(got)}, "keys": [t.key for t in ts],
            "stats": svc.stats()["completed"]}


# -- admission and ordering ----------------------------------------------------

def s_admission_quotas(P, dims, d):
    P.obs.enable(str(d))
    plan = P.plan(dims, (8, 6, 4))
    rng = np.random.default_rng(0)
    u = host(rng, (8, 6, 4))
    TQ = P.serve.TenantQuota
    svc = P.serve.PlanService(max_batch=8, max_wait_s=60.0,
                              quotas={"small": TQ(max_requests=2),
                                      "thin": TQ(max_bytes=100)})
    svc.submit("small", u, plan=plan)
    svc.submit("small", u, plan=plan)
    reasons = []
    for tenant in ("small", "thin"):
        try:
            svc.submit(tenant, u, plan=plan)
        except P.serve.AdmissionError as e:
            assert e.tenant == tenant
            reasons.append(e.reason)
    assert reasons == ["queue-depth", "inflight-bytes"]
    svc.submit("big", u, plan=plan)
    svc.drain()
    svc.submit("small", u, plan=plan)
    svc.drain()
    counters = P.counters()
    assert counters["serve.rejected{reason=queue-depth,tenant=small}"] == 1
    assert counters["serve.rejected{reason=inflight-bytes,tenant=thin}"] == 1
    P.obs.disable()
    return {"reasons": reasons, "counters": counters,
            "records": serve_records(P, str(d))}


def s_cost_ordering(P, dims, d):
    P.obs.enable(str(d))
    big = P.plan(dims, (24, 16, 12))
    small = P.plan(dims, (6, 4, 4))
    rng = np.random.default_rng(1)
    svc = P.serve.PlanService(max_batch=4, max_wait_s=0.0)
    tb = svc.submit("heavy", host(rng, (24, 16, 12)), plan=big)
    ts = svc.submit("light", host(rng, (6, 4, 4)), plan=small)
    svc.drain()
    assert ts.t_done is not None and tb.t_done is not None
    P.obs.disable()
    disp = [e for e in P.events.read_journal(str(d))
            if e["ev"] == "serve.dispatch"]
    order = [x["key"] for x in disp]
    scores = [x["score_bytes"] for x in disp]
    if math.prod(dims) > 1:
        # one rank prices every hop at zero wire bytes: only a mesh
        # orders by cost
        assert order == [ts.key, tb.key]
        assert scores[0] < scores[1]
    svc2 = P.serve.PlanService(max_batch=4, max_wait_s=0.0,
                               starve_after_s=0.0)
    tb2 = svc2.submit("heavy", host(rng, (24, 16, 12)), plan=big)
    ts2 = svc2.submit("light", host(rng, (6, 4, 4)), plan=small)
    ready = svc2.queue.take_ready(flush=True)
    assert [b.key for b in ready] == [tb2.key, ts2.key]
    for b in ready:
        svc2._dispatch(b)
    return {"order": order, "scores": scores,
            "starved": [b.key for b in ready]}


def s_close_drops_private_executables(P, dims):
    """A closed service's private registry: the port drops its
    executables (freeing their CUDA graphs on the card, which the
    engine's dispatch log would otherwise keep alive through the plan);
    the JAX package keeps them.  A registry the service was given keeps
    its executables in both."""
    plan = P.plan(dims, (8, 6, 4), real=True)
    rng = np.random.default_rng(11)
    shared = P.serve.PlanRegistry()
    served = []
    for reg in (None, shared):
        svc = P.serve.PlanService(max_batch=2, max_wait_s=0.0, registry=reg)
        t = svc.submit("t", host(rng, (8, 6, 4), real=True), plan=plan)
        svc.drain()
        served.append(P.gather(t.result(5)))
        assert svc.registry.stats()["executables"] == 1
        svc.close()
        kept = 1 if reg is not None or P.name == "jax" else 0
        assert svc.registry.stats()["executables"] == kept
    return {"fft": {"served": np.stack(served)}}


def s_single_sample_and_close(P, dims):
    plan = P.plan(dims, (8, 6, 4))
    svc = P.serve.PlanService()
    out = []
    try:
        svc.submit("t", P.pa.PencilArray.zeros(
            plan.input_pencil, (2,), plan.dtype_physical), plan=plan)
    except P.serve.ServeError as e:
        assert "single-sample" in str(e)
        out.append(type(e).__name__)
    svc.close()
    try:
        svc.submit("t", np.zeros((8, 6, 4), np.complex64), plan=plan)
    except P.serve.ServiceClosedError as e:
        out.append(type(e).__name__)
    assert out == ["ServeError", "ServiceClosedError"]
    return {"errors": out}


def s_wrong_pencil_payload(P, dims):
    plan = P.plan(dims, (8, 6, 4))
    svc = P.serve.PlanService(max_batch=4, max_wait_s=0.0)
    bad = P.pa.PencilArray.zeros(plan.output_pencil, (),
                                 plan.dtype_spectral)
    t = svc.submit("t", bad, plan=plan, direction="forward")
    svc.drain()
    assert isinstance(t.error(), P.serve.StaleRequestError)
    return {"outcome": outcome(t)}


def s_bad_payload_in_batch(P, dims):
    plan = P.plan(dims, (8, 6, 4))
    rng = np.random.default_rng(6)
    svc = P.serve.PlanService(max_batch=4, max_wait_s=0.0)
    stale = P.pa.PencilArray.zeros(plan.output_pencil, (),
                                   plan.dtype_spectral)
    good = host(rng, (8, 6, 4))
    t_bad = svc.submit("alice", stale, plan=plan, direction="forward")
    t_good = svc.submit("bob", good, plan=plan, direction="forward")
    svc.drain()
    assert isinstance(t_bad.error(), P.serve.StaleRequestError)
    ref = plan.compile(()).forward(P.from_global(plan.input_pencil, good))
    g = P.gather(t_good.result(5))
    assert np.array_equal(g, P.gather(ref))
    st = svc.stats()["completed"]
    assert st == {"ok": 1, "StaleRequestError": 1}
    return {"fft": {"good": g}, "completed": st}


def s_malformed_host_shape(P, dims):
    plan = P.plan(dims, (8, 6, 4))
    svc = P.serve.PlanService(max_batch=4, max_wait_s=0.0)
    msg = None
    try:
        svc.submit("t", np.zeros((9, 6, 4), np.complex64), plan=plan)
    except P.serve.ServeError as e:
        msg = str(e)
    assert msg is not None and "shape" in msg
    assert svc.queue.depth() == 0
    return {"msg": msg}


def s_complex_to_r2c(P, dims):
    plan = P.plan(dims, (8, 6, 4), real=True)
    svc = P.serve.PlanService(max_batch=4, max_wait_s=0.0)
    msg = None
    try:
        svc.submit("t", np.zeros((8, 6, 4), np.complex64), plan=plan)
    except P.serve.ServeError as e:
        msg = str(e)
    assert msg is not None and "imaginary" in msg
    assert svc.queue.depth() == 0
    return {"msg": msg.replace("complex64", "<dt>")}


# -- tenant isolation ----------------------------------------------------------

def _pa_obs(P, obs_dir):
    assert P.obs_main(["lint", obs_dir]) == 0, "pa-obs lint failed"
    assert P.obs_main(["timeline", obs_dir]) == 0, "pa-obs timeline failed"
    return P.timeline.merge_journals(obs_dir).events


def s_isolation_sdc(P, dims, d):
    obs_dir = str(d / "obs")
    P.obs.enable(obs_dir)
    P.guard.enable(str(d / "bundles"))
    plan_a = P.plan(dims, (6, 4, 4))
    plan_b = P.plan(dims, (12, 8, 6))
    rng = np.random.default_rng(11)
    ua = host(rng, (6, 4, 4))
    ubs = [host(rng, (12, 8, 6)) for _ in range(2)]
    svc = P.serve.PlanService(max_batch=4, max_wait_s=0.0,
                              retry=P.RetryPolicy(max_attempts=1))
    with P.faults.active("hop.exchange:corrupt*1@1"):
        ta = svc.submit("alice", ua, plan=plan_a)
        tbs = [svc.submit("bob", u, plan=plan_b) for u in ubs]
        svc.drain()
    assert isinstance(ta.error(), P.IntegrityError), ta.error()
    got = []
    for u, t in zip(ubs, tbs):
        ref = plan_b.forward(P.from_global(plan_b.input_pencil, u))
        g = P.gather(t.result(5))
        assert np.array_equal(g, P.gather(ref)), \
            "another tenant's request was poisoned"
        got.append(g)
    st = svc.stats()["completed"]
    assert st == {"ok": 2, "IntegrityError": 1}
    P.obs.disable()
    P.guard.disable()
    events = _pa_obs(P, obs_dir)
    assert {e["tenant"] for e in events if e["ev"] == "serve.request"} == \
        {"alice", "bob"}
    assert len([e for e in events if e["ev"] == "serve.coalesce"]) == 2
    assert len([e for e in events if e["ev"] == "serve.dispatch"]) == 2
    comp = {e["req"]: e for e in events if e["ev"] == "serve.complete"}
    assert comp[ta.id]["outcome"] == "IntegrityError"
    assert all(comp[t.id]["outcome"] == "ok" for t in tbs)
    assert [e for e in events if e["ev"] == "guard.sdc"]
    rec = [e for e in events if e["ev"] == "guard.recover"]
    assert any(e.get("tenants") == ["alice"] for e in rec), rec
    txt = P.timeline.render(P.timeline.merge_journals(obs_dir))
    assert f"serve alice#{ta.id}:IntegrityError" in txt
    return {"fft": {"bob": np.stack(got)}, "completed": st,
            "records": serve_records(P, obs_dir)}


def s_isolation_later_traffic(P, dims, d):
    P.guard.enable(str(d / "bundles"))
    plan = P.plan(dims, (8, 6, 4))
    rng = np.random.default_rng(2)
    svc = P.serve.PlanService(max_batch=4, max_wait_s=0.0,
                              retry=P.RetryPolicy(max_attempts=1))
    u1, u2 = host(rng, (8, 6, 4)), host(rng, (8, 6, 4))
    with P.faults.active("hop.exchange:corrupt*1@1"):
        t1 = svc.submit("alice", u1, plan=plan)
        svc.drain()
        t2 = svc.submit("alice", u2, plan=plan)
        svc.drain()
    assert isinstance(t1.error(), P.IntegrityError)
    ref = plan.forward(P.from_global(plan.input_pencil, u2))
    g = P.gather(t2.result(5))
    assert np.array_equal(g, P.gather(ref))
    P.guard.disable()
    return {"fft": {"t2": g}, "outcomes": [outcome(t1), outcome(t2)]}


def s_guarded_retry_transient(P, dims, d):
    P.guard.enable(str(d / "bundles"))
    plan = P.plan(dims, (8, 6, 4))
    rng = np.random.default_rng(4)
    u = host(rng, (8, 6, 4))
    svc = P.serve.PlanService(max_batch=4, max_wait_s=0.0,
                              retry=P.RetryPolicy(max_attempts=2,
                                                  base_delay=0.01))
    with P.faults.active("hop.exchange:corrupt*1@1"):
        t = svc.submit("alice", u, plan=plan)
        svc.drain()
    ref = plan.forward(P.from_global(plan.input_pencil, u))
    g = P.gather(t.result(5))
    assert np.array_equal(g, P.gather(ref))
    P.guard.disable()
    return {"fft": {"t": g}, "outcome": outcome(t)}


def s_meta_reserved_keys(P, d):
    from importlib import import_module

    rec_mod = import_module(P.guard.__name__ + ".recover")
    P.obs.enable(str(d))
    calls = {"n": 0}

    def fn():
        calls["n"] += 1
        if calls["n"] == 1:
            raise P.IntegrityError("injected", hop="t")
        return "ok"

    out = rec_mod.guarded_step(
        fn, retry=P.RetryPolicy(max_attempts=2, base_delay=0.0),
        label="meta-step",
        meta={"label": "sneaky", "stage": "sneaky", "ev": "sneaky",
              "_fsync": "sneaky", "tenant": "alice"})
    assert out == "ok"
    recs = [e for e in P.events.read_journal(str(d))
            if e["ev"] == "guard.recover"]
    assert recs and all(e["label"] == "meta-step" for e in recs)
    assert all(e.get("tenant") == "alice" for e in recs)
    assert all("_fsync" not in e for e in recs)
    P.obs.disable()
    return {"records": [sorted((k, str(v)) for k, v in e.items()
                               if k not in VOLATILE) for e in recs]}


def s_named_plan_rebind(P, dims):
    rng = np.random.default_rng(9)
    svc = P.serve.PlanService(max_batch=4, max_wait_s=60.0)

    def factory(ctx=None):
        return P.plan(dims, (8, 6, 4), real=True)

    try:
        p0 = svc.register_plan("served", factory)
        assert svc.plan("served") is p0
        us = [host(rng, (8, 6, 4), real=True) for _ in range(3)]
        ts = [svc.submit("t", u, name="served") for u in us[:2]]
        ts.append(svc.submit("t2", us[2], plan=p0))
        rebuilt = P.elastic._registry["serve:served"](None)
        assert svc.plan("served") is rebuilt and rebuilt is not p0
        assert rebuilt.plan_key() == p0.plan_key()
        assert all(e.plan is rebuilt for e in svc.queue.pending_entries())
        svc.drain()
        cp = rebuilt.compile(())
        got = []
        for u, t in zip(us, ts):
            ref = cp.forward(P.from_global(rebuilt.input_pencil, u))
            g = P.gather(t.result(5))
            assert np.array_equal(g, P.gather(ref))
            got.append(g)
        svc.close()
        assert "serve:served" not in P.elastic._registry
    finally:
        P.elastic.unregister_plan("serve:served")
    return {"fft": {"served": np.stack(got)}}


# -- the serve whales (hbm-limited reshards) -----------------------------------

def _ref_u(shape):
    return np.arange(math.prod(shape), dtype=np.float32).reshape(shape)


def s_whale_admitted(P, dims):
    topo = P.topo(dims)
    shape = (16, 12, 8)
    pin = P.pa.Pencil(topo, shape, (1, 2))
    dest = P.pa.Pencil(topo, shape, (0, 1))
    svc = P.serve.PlanService(max_batch=1, hbm_limit=1920)
    try:
        u = _ref_u(shape)
        x = P.from_global(pin, u)
        t_whale = svc.submit_reshard("whale", x, dest)
        plan = P.pa.PencilFFTPlan(topo, shape, real=True)
        t_small = svc.submit("small", _ref_u(shape), plan=plan)
        svc.drain()
        got = P.gather(t_whale.result(timeout=60))
        ref = P.gather(P.pa.reshard(x, dest, method=P.pa.Gspmd()))
        np.testing.assert_array_equal(got, ref)
        small = P.gather(t_small.result(timeout=60))
        exp = P.gather(plan.forward(P.from_global(plan.input_pencil, u)))
        np.testing.assert_allclose(small, exp, rtol=1e-5, atol=1e-5)
    finally:
        svc.close()
    return {"bits": {"whale": got}, "fft": {"small": small},
            "key": t_whale.key}


def s_whale_rejected(P, dims):
    topo = P.topo(dims)
    pin = P.pa.Pencil(topo, (16, 12, 8), (1, 2))
    dest = P.pa.Pencil(topo, (16, 12, 8), (0, 1))
    svc = P.serve.PlanService(max_batch=1, hbm_limit=1791)
    reason = None
    try:
        x = P.from_global(pin, _ref_u((16, 12, 8)))
        try:
            svc.submit_reshard("whale", x, dest)
        except P.serve.AdmissionError as e:
            reason = e.reason
        assert reason == "hbm-limit"
        assert svc.queue.depth() == 0
    finally:
        svc.close()
    return {"reason": reason}


def s_whales_do_not_coalesce(P, dims):
    topo = P.topo(dims)
    shape = (16, 12, 8)
    pin = P.pa.Pencil(topo, shape, (1, 2))
    dest = P.pa.Pencil(topo, shape, (0, 1))
    svc = P.serve.PlanService(max_batch=8, max_wait_s=10.0, hbm_limit=1920)
    try:
        u1, u2 = _ref_u(shape), _ref_u(shape) + 1.0
        t1 = svc.submit_reshard("a", P.from_global(pin, u1), dest)
        t2 = svc.submit_reshard("b", P.from_global(pin, u2), dest)
        assert t1.key != t2.key
        svc.drain()
        g1, g2 = P.gather(t1.result(60)), P.gather(t2.result(60))
        np.testing.assert_array_equal(g1, u1)
        np.testing.assert_array_equal(g2, u2)
        assert svc.stats()["dispatches"] == 2
    finally:
        svc.close()
    return {"bits": {"a": g1, "b": g2},
            "keys": [t.key.split("#solo")[0] for t in (t1, t2)]}


# -- precision -----------------------------------------------------------------

def _degrade_service(P, **slos):
    """Batches leave the queue by priced cost alone: with the default
    1 s starvation bound a slow submission on a loaded host (JAX's)
    turns the take into admission order, and the journals' order apart."""
    svc = P.serve.PlanService(
        max_batch=4, max_wait_s=60.0, starve_after_s=60.0, slos=dict(slos),
        pressure=P.serve.PressurePolicy(high_water_s=1.0, low_water_s=0.1,
                                        degrade_water_s=0.5))
    svc._gate.update = lambda *a, **k: svc._gate._state
    return svc


def s_degrade_within_budget(P, dims, d):
    SLO = P.serve.SLO
    P.obs.enable(str(d))
    plan = P.plan(dims, (16, 12, 20), dtype="complex64")
    svc = _degrade_service(P, gold=SLO(shed_priority=2),
                           flex=SLO(shed_priority=0, max_rel_l2=0.5),
                           rigid=SLO(shed_priority=0))
    svc._gate._state = "degrade"
    rng = np.random.default_rng(0)
    u = host(rng, (16, 12, 20))
    t_gold = svc.submit("gold", u, plan=plan)
    t_flex = svc.submit("flex", u, plan=plan)
    t_rigid = svc.submit("rigid", u, plan=plan)
    assert t_gold.key == f"fft:{plan.plan_key()}:forward"
    assert t_rigid.key == t_gold.key and t_flex.key != t_gold.key
    svc.drain()
    ref = np.fft.fftn(u)
    r_gold = P.gather(t_gold.result(30))
    r_flex = P.gather(t_flex.result(30))
    rel_flex = np.linalg.norm(r_flex - ref) / np.linalg.norm(ref)
    rel_gold = np.linalg.norm(r_gold - ref) / np.linalg.norm(ref)
    assert rel_gold < 1e-5
    assert 1e-4 < rel_flex < 0.5
    keys = svc.registry.keys()
    assert t_gold.key.split(":")[1] in keys
    assert t_flex.key.split(":")[1] in keys
    svc.close()
    P.obs.disable()
    evs = P.events.read_journal(str(d))
    prec = [e for e in evs if e["ev"] == "serve.precision"]
    assert len(prec) == 1
    rec = prec[0]
    assert rec["v"] >= 7 and rec["tenant"] == "flex"
    assert rec["wire_from"] == "full"
    assert rec["wire_to"] in ("bf16", "fp8_e4m3")
    assert rec["envelope"] <= rec["max_rel_l2"] == 0.5
    assert rec["trace"] and rec["gate"] == "degrade"
    assert P.schema.lint_journal(evs) == []
    reqs = [e for e in evs if e["ev"] == "serve.request"
            and e.get("trace") == rec["trace"]]
    assert len(reqs) == 1 and reqs[0]["tenant"] == "flex"
    # the gold/rigid and flex batches write disjoint engine resources in
    # the JAX package, whose engine issues them by lane when both are
    # queued and in take order when its consumer is idle: the order of
    # their completions is the host's timing, so it is compared sorted
    recs = serve_records(P, str(d))
    done = sorted((r for r in recs if r[0] == "serve.complete"),
                  key=lambda r: json.dumps(r[2], sort_keys=True,
                                           default=str))
    return {"fft": {"gold": r_gold}, "flex_key": t_flex.key,
            "wire_to": rec["wire_to"], "envelope": rec["envelope"],
            "rel_flex_ok": bool(1e-4 < rel_flex < 0.5),
            "records": [r for r in recs if r[0] != "serve.complete"]
            + done}


def s_shed_serves_budget(P, dims):
    SLO = P.serve.SLO
    plan = P.plan(dims, (16, 12, 20), dtype="complex64")
    svc = _degrade_service(P, gold=SLO(shed_priority=2),
                           flex=SLO(shed_priority=0, max_rel_l2=0.5),
                           rigid=SLO(shed_priority=0))
    svc._gate._state = "shed"
    rng = np.random.default_rng(1)
    u = host(rng, (16, 12, 20))
    t_gold = svc.submit("gold", u, plan=plan)
    t_flex = svc.submit("flex", u, plan=plan)
    reason = None
    try:
        svc.submit("rigid", u, plan=plan)
    except P.serve.AdmissionError as e:
        reason = e.reason
    assert reason == "shed"
    svc.drain()
    assert t_gold.result(30) is not None and t_flex.result(30) is not None
    svc.close()
    return {"reason": reason, "outcomes": [outcome(t_gold),
                                           outcome(t_flex)]}


def s_degraded_never_coalesces(P, dims):
    SLO = P.serve.SLO
    plan = P.plan(dims, (16, 12, 20), dtype="complex64")
    svc = _degrade_service(P, gold=SLO(shed_priority=2),
                           flex=SLO(shed_priority=0, max_rel_l2=0.5))
    rng = np.random.default_rng(2)
    svc._gate._state = "ok"
    t_a = svc.submit("gold", host(rng, (16, 12, 20)), plan=plan)
    svc._gate._state = "degrade"
    t_b = svc.submit("flex", host(rng, (16, 12, 20)), plan=plan)
    assert t_a.key != t_b.key
    batches = svc.queue.take_ready(flush=True)
    assert svc.queue.take_ready(flush=True) == []
    for b in batches:
        svc._dispatch(b)
    assert len(batches) == 2
    assert {b.key for b in batches} == {t_a.key, t_b.key}
    assert all(len(b.entries) == 1 for b in batches)
    svc.close()
    return {"keys": sorted(b.key for b in batches)}


def s_no_budget_no_degrade(P, dims):
    SLO = P.serve.SLO
    plan = P.plan(dims, (16, 12, 20), dtype="complex64")
    rng = np.random.default_rng(3)
    u = host(rng, (16, 12, 20))
    base = P.serve.PlanService(max_batch=4, max_wait_s=60.0)
    t0 = base.submit("t", u, plan=plan)
    base.drain()
    r0 = P.gather(t0.result(30))
    base.close()
    svc = _degrade_service(P, t=SLO(shed_priority=0),
                           gold=SLO(shed_priority=2))
    svc._gate._state = "degrade"
    t1 = svc.submit("t", u, plan=plan)
    assert t1.key == t0.key
    svc.drain()
    r1 = P.gather(t1.result(30))
    svc.close()
    np.testing.assert_array_equal(r0, r1)
    return {"fft": {"r": r1}, "key": t1.key}


def s_registry_variants(P, dims):
    plan = P.plan(dims, (16, 12, 10), real=True, dtype="float32")
    reg = P.serve.PlanRegistry()
    reg.register(plan)
    v = plan.with_wire_dtype("fp8_e4m3")
    reg.register(v)
    c_full = reg.compiled(plan, ())
    c_fp8 = reg.compiled(v, ())
    assert c_full is not c_fp8
    assert reg.compiled(plan, ()) is c_full
    assert reg.compiled(v, ()) is c_fp8
    return {"keys": sorted(reg.keys()), "stats": reg.stats()}


def s_degrade_reshard(P, dims, d):
    """The port's rung on reshard traffic (no JAX counterpart: the JAX
    package's rung leaves reshards at full precision)."""
    SLO = P.serve.SLO
    P.obs.enable(str(d))
    topo = P.topo(dims)
    shape = (16, 12, 8)
    src = P.pa.Pencil(topo, shape, (1, 2))
    dst = P.pa.Pencil(topo, shape, (0, 2))
    svc = _degrade_service(P, gold=SLO(shed_priority=2),
                           flex=SLO(shed_priority=0, max_rel_l2=0.5))
    svc._gate._state = "degrade"
    u = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    x = P.from_global(src, u)
    t_gold = svc.submit_reshard("gold", x, dst)
    t_flex = svc.submit_reshard("flex", x, dst)
    assert t_gold.key != t_flex.key
    svc.drain()
    ref = P.gather(P.pa.reshard(x, dst))
    g, f = P.gather(t_gold.result(30)), P.gather(t_flex.result(30))
    svc.close()
    P.obs.disable()
    prec = [e for e in P.events.read_journal(str(d))
            if e["ev"] == "serve.precision"]
    assert len(prec) == 1 and prec[0]["tenant"] == "flex"
    assert P.schema.lint_journal(P.events.read_journal(str(d))) == []
    rel = float(np.linalg.norm(f - ref) / np.linalg.norm(ref))
    return {"rel_err": rel, "envelope": prec[0]["envelope"],
            "wire_to": prec[0]["wire_to"],
            "gold_bits": bool(np.array_equal(g, ref))}


# -- SLOs, shedding, the autoscaler --------------------------------------------

def s_disabled_path(P, dims):
    plan = P.plan(dims, (8, 6, 4))
    rng = np.random.default_rng(0)
    svc = P.serve.PlanService(max_batch=4, max_wait_s=60.0)
    assert not svc._slo_armed
    svc.submit("t", host(rng, (8, 6, 4)), plan=plan)
    assert svc.queue.load.snapshot()["queued_cost_bytes"] == 0
    assert svc.queue.load.projected_wait_s() is None
    svc.drain()
    assert svc.queue.load.rate_bytes_per_s() is None
    assert svc.stats()["pressure"] is None
    return {"stats": svc.stats()["completed"]}


def s_deadline_boundary(P, dims):
    SLO = P.serve.SLO
    plan = P.plan(dims, (8, 6, 4))
    rng = np.random.default_rng(1)
    svc = P.serve.PlanService(max_batch=8, max_wait_s=60.0,
                              slos={"bulk": SLO(shed_priority=0)})
    for _ in range(3):
        svc.submit("bulk", host(rng, (8, 6, 4)), plan=plan)
    cost = svc.queue.load.snapshot()["queued_cost_bytes"] // 3
    assert cost > 0
    svc.queue.load.note_completed(cost, 1, 2.0)
    projected = svc.queue.load.projected_wait_s()
    assert projected is not None and projected > 0
    svc.set_slo("edge", SLO(deadline_s=projected))
    t_ok = svc.submit("edge", host(rng, (8, 6, 4)), plan=plan)
    assert t_ok.error() is None
    projected2 = svc.queue.load.projected_wait_s()
    svc.set_slo("tight", SLO(deadline_s=projected2 * 0.5))
    err = None
    try:
        svc.submit("tight", host(rng, (8, 6, 4)), plan=plan)
    except P.serve.DeadlineError as e:
        err = e
    assert err is not None and err.reason == "projected"
    assert err.tenant == "tight"
    assert abs(err.projected_s - projected2) <= 1e-9 * projected2
    assert abs(err.deadline_s - projected2 * 0.5) <= 1e-9 * projected2
    assert svc.queue.depth("tight") == 0
    svc.drain()
    return {"cost": cost, "projected": [projected, projected2],
            "reason": err.reason}


def s_blind_tracker(P, dims):
    plan = P.plan(dims, (8, 6, 4))
    rng = np.random.default_rng(2)
    svc = P.serve.PlanService(max_batch=4, max_wait_s=60.0,
                              slos={"dl": P.serve.SLO(deadline_s=1e-9)})
    t = svc.submit("dl", host(rng, (8, 6, 4)), plan=plan)
    assert t.error() is None
    svc.drain()
    return {"outcome": outcome(t).split(":")[0]}


def s_expired_shed(P, dims, d):
    plan = P.plan(dims, (8, 6, 4))
    rng = np.random.default_rng(3)
    P.obs.enable(str(d))
    svc = P.serve.PlanService(max_batch=4, max_wait_s=60.0,
                              slos={"dl": P.serve.SLO(deadline_s=0.03)})
    t = svc.submit("dl", host(rng, (8, 6, 4)), plan=plan)
    time.sleep(0.08)
    assert svc.drain() == 0
    err = t.error()
    assert isinstance(err, P.serve.DeadlineError) and err.reason == "expired"
    assert err.tenant == "dl"
    assert svc.stats()["completed"] == {"DeadlineError": 1}
    svc.submit("dl", host(rng, (8, 6, 4)), plan=plan)
    svc.drain()
    P.obs.disable()
    events = P.events.read_journal(str(d))
    comp = [e for e in events if e["ev"] == "serve.complete"
            and e["outcome"] == "DeadlineError"]
    assert len(comp) == 1 and comp[0]["req"] == t.id
    counters = P.counters()
    assert counters["serve.shed{reason=expired,tenant=dl}"] == 1
    # the second request's own lateness is a matter of clocks (JAX's
    # first dispatch of the shape compiles): its violation is left out
    return {"counters": {k: v for k, v in counters.items()
                         if "shed" in k or "completed" in k},
            "records": [r for r in serve_records(P, str(d))
                        if r[0] != "serve.slo_violation"]}


def s_expiry_feeds_pump(P, dims):
    plan = P.plan(dims, (8, 6, 4))
    rng = np.random.default_rng(4)
    svc = P.serve.PlanService(max_batch=8, max_wait_s=30.0,
                              slos={"dl": P.serve.SLO(deadline_s=0.05)})
    svc.submit("dl", host(rng, (8, 6, 4)), plan=plan)
    wait = svc.queue.next_ready_in()
    assert wait is not None and wait <= 0.05 + 1e-3, wait
    svc.drain()
    return {"bounded": wait <= 0.05 + 1e-3}


def s_streaming_sheds_at_deadline(P, dims):
    plan = P.plan(dims, (8, 6, 4))
    rng = np.random.default_rng(15)
    svc = P.serve.PlanService(
        max_batch=8, max_wait_s=5.0,
        slos={"dl": P.serve.SLO(deadline_s=0.1, shed_priority=1)})
    svc.start()
    t0 = time.monotonic()
    t = svc.submit("dl", host(rng, (8, 6, 4)), plan=plan)
    err = None
    try:
        t.result(3)
    except P.serve.DeadlineError as e:
        err = e
    assert err is not None and err.reason == "expired"
    assert time.monotonic() - t0 < 2.0
    svc.close()
    return {"reason": err.reason}


def s_late_completion(P, dims, d):
    """A request dispatched in time and finished late.  The JAX test
    makes it late by the first dispatch's XLA compile past a 20 ms
    deadline, but a request queued 20 ms on a loaded host is shed before
    its dispatch instead.  Here both packages run the guarded (eager)
    schedule, whose exchange the ``hop.exchange:delay`` fault drags 1.5 s
    past a 1 s deadline: late by the same margin in both, and on every
    rank."""
    plan = P.plan(dims, (10, 8, 6))
    rng = np.random.default_rng(5)
    P.obs.enable(str(d))
    svc = P.serve.PlanService(
        max_batch=4, max_wait_s=60.0,
        slos={"dl": P.serve.SLO(deadline_s=1.0, p99_budget_s=0.05)})
    u = host(rng, (10, 8, 6))
    P.guard.enable(os.path.join(str(d), "bundles"))
    t = svc.submit("dl", u, plan=plan)
    os.environ[P.faults.DELAY_S_VAR] = "1.5"
    try:
        with P.faults.active("hop.exchange:delay"):
            svc.drain()
    finally:
        os.environ.pop(P.faults.DELAY_S_VAR, None)
        P.guard.disable()
    ref = plan.compile(()).forward(P.from_global(plan.input_pencil, u))
    g = P.gather(t.result(5))
    assert np.array_equal(g, P.gather(ref))
    assert svc.stats()["slo_violations"] == 1
    P.obs.disable()
    events = P.events.read_journal(str(d))
    viol = [e for e in events if e["ev"] == "serve.slo_violation"]
    assert len(viol) == 1
    assert viol[0]["tenant"] == "dl" and viol[0]["req"] == t.id
    assert abs(viol[0]["deadline_s"] - 1.0) < 1e-9
    assert viol[0]["late_s"] > 0
    counters = P.counters()
    assert counters["serve.slo_violations{tenant=dl}"] == 1
    if P.rank0():
        assert P.obs_main(["lint", str(d)]) == 0
        assert P.obs_main(["timeline", str(d)]) == 0
    return {"fft": {"t": g}, "violations": 1,
            "counter": counters["serve.slo_violations{tenant=dl}"]}


def _storm_service(P, dims, evict_water_s=None):
    SLO = P.serve.SLO
    plan = P.plan(dims, (8, 6, 4))
    svc = P.serve.PlanService(
        max_batch=8, max_wait_s=60.0,
        slos={"prot": SLO(shed_priority=10), "bulk": SLO(shed_priority=0)},
        pressure=P.serve.PressurePolicy(high_water_s=0.5, low_water_s=0.1,
                                        evict_water_s=evict_water_s))
    return svc, plan


def s_shed_at_submit(P, dims, d):
    P.obs.enable(str(d))
    rng = np.random.default_rng(6)
    svc, plan = _storm_service(P, dims)
    u = host(rng, (8, 6, 4))
    for _ in range(2):
        svc.submit("prot", u, plan=plan)
    cost = svc.queue.load.snapshot()["queued_cost_bytes"] // 2
    svc.queue.load.note_completed(cost, 1, 10.0)
    assert svc.queue.load.drain_s() > 0.5
    reasons = []
    for tenant in ("bulk", "prot", "anon"):
        try:
            t = svc.submit(tenant, u, plan=plan)
            assert t.error() is None
            reasons.append("admitted")
        except P.serve.AdmissionError as e:
            assert e.tenant == tenant
            reasons.append(e.reason)
    assert reasons == ["shed", "admitted", "shed"]
    svc.queue.load.note_completed(100 * cost, 1, 0.001)
    svc.drain()
    assert svc.queue.load.drain_s() < 0.1
    t2 = svc.submit("bulk", u, plan=plan)
    assert t2.error() is None
    svc.drain()
    P.obs.disable()
    counters = P.counters()
    assert counters["serve.rejected{reason=shed,tenant=bulk}"] == 1
    assert counters["serve.rejected{reason=shed,tenant=anon}"] == 1
    return {"reasons": reasons, "cost": cost, "counters": counters,
            "records": serve_records(P, str(d))}


def s_evict_rung(P, dims, d):
    P.obs.enable(str(d))
    rng = np.random.default_rng(7)
    svc, plan = _storm_service(P, dims, evict_water_s=1.0)
    u = host(rng, (8, 6, 4))
    tickets = {}
    for name in ("bulk", "prot", "bulk", "prot", "bulk"):
        tickets.setdefault(name, []).append(svc.submit(name, u, plan=plan))
    cost = svc.queue.load.snapshot()["queued_cost_bytes"] // 5
    svc.queue.load.note_completed(cost, 1, 10.0)
    assert svc.queue.load.drain_s() > 1.0
    svc._slo_maintenance()
    assert len([t for t in tickets["bulk"] if t.done()]) == 3
    for t in tickets["bulk"]:
        assert isinstance(t.error(), P.serve.AdmissionError)
        assert t.error().reason == "shed"
    events = P.events.read_journal(str(d))
    shed_reqs = [e["req"] for e in events if e["ev"] == "serve.complete"
                 and e["outcome"] == "AdmissionError"]
    assert shed_reqs == sorted(t.id for t in tickets["bulk"])
    for t in tickets["prot"]:
        assert not t.done()
    svc.drain()
    for t in tickets["prot"]:
        assert t.error() is None
    P.obs.disable()
    return {"outcomes": {k: [outcome(t) for t in v]
                         for k, v in tickets.items()},
            "records": serve_records(P, str(d))}


def s_reasons_never_conflated(P, dims, dims4):
    SLO, TQ = P.serve.SLO, P.serve.TenantQuota
    plan = P.plan(dims, (8, 6, 4))
    rng = np.random.default_rng(8)
    u = host(rng, (8, 6, 4))
    svc = P.serve.PlanService(
        max_batch=8, max_wait_s=60.0,
        quotas={"small": TQ(max_requests=1), "thin": TQ(max_bytes=10)},
        slos={"prot": SLO(shed_priority=1)},
        pressure=P.serve.PressurePolicy(high_water_s=0.1, low_water_s=0.05))
    svc.submit("small", u, plan=plan)
    reasons = []

    def reject(tenant, fn):
        try:
            fn()
        except P.serve.AdmissionError as e:
            assert not isinstance(e, P.serve.DeadlineError)
            reasons.append(e.reason)

    reject("small", lambda: svc.submit("small", u, plan=plan))
    reject("thin", lambda: svc.submit("thin", u, plan=plan))
    cost = max(1, svc.queue.load.snapshot()["queued_cost_bytes"])
    svc.queue.load.note_completed(cost, 1, 100.0)
    reject("bulk", lambda: svc.submit("bulk", u, plan=plan))
    assert set(reasons) == {"queue-depth", "inflight-bytes", "shed"}
    svc.drain()
    topo4 = P.topo(dims4)
    src = P.pa.Pencil(topo4, (8, 6, 4), (1, 2))
    dst = P.pa.Pencil(topo4, (8, 6, 4), (0, 2))
    x = P.from_global(src, host(rng, (8, 6, 4)))
    svc2 = P.serve.PlanService(hbm_limit=1)
    reject("whale", lambda: svc2.submit_reshard("whale", x, dst))
    assert reasons[-1] == "hbm-limit"
    return {"reasons": reasons}


def s_submit_fault_point(P, dims):
    plan = P.plan(dims, (8, 6, 4))
    rng = np.random.default_rng(9)
    svc = P.serve.PlanService(max_batch=4, max_wait_s=60.0)
    u = host(rng, (8, 6, 4))
    injected = False
    with P.faults.active("serve.submit:error*1@2"):
        t1 = svc.submit("t", u, plan=plan)
        try:
            svc.submit("t", u, plan=plan)
        except P.InjectedFault:
            injected = True
        t3 = svc.submit("t", u, plan=plan)
        assert t3.error() is None
    assert injected and svc.queue.depth() == 2
    svc.drain()
    assert t1.error() is None
    return {"injected": injected, "outcomes": [outcome(t1), outcome(t3)]}


def s_submit_fault_delay(P, dims):
    plan = P.plan(dims, (8, 6, 4))
    rng = np.random.default_rng(10)
    svc = P.serve.PlanService(max_batch=4, max_wait_s=60.0)
    u = host(rng, (8, 6, 4))
    os.environ[P.faults.DELAY_S_VAR] = "0.15"
    try:
        with P.faults.active("serve.submit:delay@1"):
            t0 = time.monotonic()
            svc.submit("t", u, plan=plan)
            dragged = time.monotonic() - t0 >= 0.15
    finally:
        os.environ.pop(P.faults.DELAY_S_VAR, None)
    assert dragged and svc.queue.depth() == 1
    svc.drain()
    return {"dragged": dragged}


def _loaded_service(P, dims, rng, drain_s):
    plan = P.plan(dims, (8, 6, 4))
    svc = P.serve.PlanService(max_batch=8, max_wait_s=60.0,
                              slos={"t": P.serve.SLO(shed_priority=0)})
    svc.submit("t", host(rng, (8, 6, 4)), plan=plan)
    cost = svc.queue.load.snapshot()["queued_cost_bytes"]
    svc.queue.load.note_completed(cost, 1, drain_s)
    return svc


def _decision(dd):
    return [dd.direction, dd.reason, dd.acted, dd.detail]


def s_autoscaler_windows(P, dims, d):
    P.obs.enable(str(d))
    rng = np.random.default_rng(11)
    svc = _loaded_service(P, dims, rng, drain_s=5.0)
    asc = P.serve.Autoscaler(svc, policy=P.serve.AutoscalePolicy(
        overload_drain_s=1.0, windows=3, cooldown_s=0.0))
    ticks = [asc.tick() for _ in range(4)]
    assert [t.direction for t in ticks] == ["hold", "hold", "up", "hold"]
    d3 = ticks[2]
    assert d3.reason == "overload" and not d3.acted
    assert d3.detail == "no-coordinator"
    assert abs(d3.projection["drain_s"] - 5.0) < 1e-9
    P.obs.disable()
    scale = [e for e in P.events.read_journal(str(d))
             if e["ev"] == "serve.scale"]
    assert len(scale) == 1 and scale[0]["acted"] is False
    assert abs(scale[0]["projection"]["drain_s"] - 5.0) < 1e-9
    svc.drain()
    return {"ticks": [_decision(t) for t in ticks],
            "records": serve_records(P, str(d))}


def s_autoscaler_interrupted(P, dims):
    rng = np.random.default_rng(12)
    svc = _loaded_service(P, dims, rng, drain_s=5.0)
    asc = P.serve.Autoscaler(svc, policy=P.serve.AutoscalePolicy(
        overload_drain_s=1.0, windows=2, cooldown_s=0.0))
    a = asc.tick()
    svc.drain()
    b = asc.tick()
    assert (a.direction, b.direction) == ("hold", "hold")
    assert asc.decisions == 0
    return {"ticks": [_decision(a), _decision(b)]}


def s_autoscaler_cooldown(P, dims):
    rng = np.random.default_rng(13)
    svc = _loaded_service(P, dims, rng, drain_s=5.0)
    asc = P.serve.Autoscaler(svc, policy=P.serve.AutoscalePolicy(
        overload_drain_s=1.0, windows=1, cooldown_s=3600.0))
    a, b = asc.tick(), asc.tick()
    assert a.direction == "up"
    assert b.direction == "hold" and b.reason == "cooldown"
    assert asc.decisions == 1
    svc.drain()
    return {"ticks": [_decision(a), _decision(b)]}


def s_autoscaler_idle_down(P, d):
    P.obs.enable(str(d))
    svc = P.serve.PlanService(max_batch=4,
                              slos={"t": P.serve.SLO(shed_priority=0)})
    asc = P.serve.Autoscaler(svc, policy=P.serve.AutoscalePolicy(
        overload_drain_s=1.0, windows=2, cooldown_s=0.0))
    a, b = asc.tick(), asc.tick()
    assert a.direction == "hold"
    assert b.direction == "down" and b.reason == "idle"
    assert not b.acted and b.detail == "no-coordinator"
    P.obs.disable()
    assert [e["direction"] for e in P.events.read_journal(str(d))
            if e["ev"] == "serve.scale"] == ["down"]
    return {"ticks": [_decision(a), _decision(b)],
            "records": serve_records(P, str(d))}


def s_autoscaler_highest_rank(P, d):
    kv = P.FileKV(str(d / "kv"))
    c0 = P.Coordinator(kv, 0, 2, lease_ttl=30.0, verdict_timeout=20)
    c1 = P.Coordinator(kv, 1, 2, lease_ttl=30.0, verdict_timeout=20)
    try:
        svc = P.serve.PlanService(max_batch=4,
                                  slos={"t": P.serve.SLO(shed_priority=0)})
        pol = P.serve.AutoscalePolicy(windows=1, cooldown_s=0.0,
                                      min_world=1)
        a0 = P.serve.Autoscaler(svc, coordinator=c0, policy=pol)
        a1 = P.serve.Autoscaler(svc, coordinator=c1, policy=pol)
        d0, d1 = a0.tick(), a1.tick()
        assert (d0.direction, d1.direction) == ("down", "down")
        assert not d0.acted and d0.detail == "not-leaver"
        assert d1.acted and d1.detail == "leaving-rank=1"
        assert c1.leaving and not c0.leaving
        a2 = P.serve.Autoscaler(svc, coordinator=c0,
                                policy=P.serve.AutoscalePolicy(
                                    windows=1, cooldown_s=0.0, min_world=2))
        d2 = a2.tick()
        assert d2.direction == "down" and d2.detail == "at-min-world"
    finally:
        c0.shutdown()
        c1.shutdown()
        P.cluster._reset_for_tests()
    return {"ticks": [_decision(x) for x in (d0, d1, d2)]}


def s_prewarm(P, dims, d):
    P.obs.enable(str(d))

    def factory(ctx=None):
        return P.plan(dims, (8, 6, 4), real=True)

    rep = P.autoscale.prewarm_plans({"warm": factory})
    assert rep["plans"] == 1 and rep["warm_s"] > 0
    assert "warm" in rep["per_plan_s"]
    P.obs.disable()
    pre = [e for e in P.events.read_journal(str(d))
           if e["ev"] == "serve.scale" and e["reason"] == "prewarm"]
    assert len(pre) == 1 and pre[0]["projection"]["plans"] == 1
    return {"keys": sorted(rep), "plans": rep["plans"],
            "compile_cache": rep["compile_cache"]}


def s_restore_failure_resumes(P, d):
    engine = P.engine.get_engine()
    gen0 = engine.generation
    assert engine.quiesce(5)
    held = engine.submit(lambda: "held-survives", label="held")
    kv = P.FileKV(str(d / "kv"))
    c0 = P.Coordinator(kv, 0, 1, lease_ttl=5.0, verdict_timeout=20)
    mgr = P.CheckpointManager(str(d / "ck"))
    stage = None
    try:
        try:
            P.elastic.reform(c0, reason="drill", install=False,
                             ckpt_mgr=mgr, restore=lambda c: None)
        except P.cluster.ReformError as e:
            stage = e.stage
        assert stage == "restore"
        assert engine.generation == gen0
        assert held.result(10) == "held-survives"
    finally:
        c0.shutdown()
        P.cluster._reset_for_tests()
    return {"stage": stage}


def s_successful_reform_drops_held(P, d):
    engine = P.engine.get_engine()
    gen0 = engine.generation
    assert engine.quiesce(5)
    held = engine.submit(lambda: "never", label="held")
    kv = P.FileKV(str(d / "kv"))
    c0 = P.Coordinator(kv, 0, 1, lease_ttl=5.0, verdict_timeout=20)
    mgr = P.CheckpointManager(str(d / "ck"))
    pen = P.pa.Pencil(P.topo((1,)), (4, 4), (0,))
    mgr.save(1, {"u": P.from_global(pen, np.ones((4, 4), np.float32))})
    dropped = False
    try:
        r = P.elastic.reform(c0, reason="drill", install=False,
                             ckpt_mgr=mgr, restore=lambda c: None)
        assert r.restored_step == 1
        assert engine.generation == gen0 + 1
        try:
            held.result(10)
        except P.eerrors.EngineReformedError:
            dropped = True
        assert dropped
        r.coordinator.shutdown()
    finally:
        c0.shutdown()
        P.cluster._reset_for_tests()
    return {"restored_step": 1, "dropped": dropped}


def s_reformed_batch_resubmits(P, dims):
    import threading

    plan = P.plan(dims, (8, 6, 4))
    rng = np.random.default_rng(14)
    engine = P.engine.get_engine()
    svc = P.serve.PlanService(max_batch=4, max_wait_s=0.0)
    u = host(rng, (8, 6, 4))
    assert engine.quiesce(5)
    t = svc.submit("t", u, plan=plan)
    stepper = threading.Thread(target=svc.step, kwargs={"flush": True},
                               daemon=True)
    stepper.start()
    deadline = time.monotonic() + 10
    while engine.depth() == 0 and time.monotonic() < deadline:
        time.sleep(0.005)
    assert engine.depth() == 1
    engine.reform()
    stepper.join(timeout=10)
    assert not stepper.is_alive()
    assert not t.done()
    svc.step(flush=True)
    ref = plan.compile(()).forward(P.from_global(plan.input_pencil, u))
    g = P.gather(t.result(10))
    assert np.array_equal(g, P.gather(ref))
    assert svc.stats()["completed"] == {"ok": 1}
    svc.close()
    return {"fft": {"t": g}, "completed": {"ok": 1}}


# -- the engine's serve cases --------------------------------------------------

def _payload(rng):
    return host(rng, (8, 6, 4))


def s_not_wedged_by_pool_failure(P, dims):
    plan = P.plan(dims, (8, 6, 4))
    rng = np.random.default_rng(5)
    engine = P.engine.Engine("wedge", workers=2)

    def poison():
        raise RuntimeError("poison")

    engine.submit(lambda x: x, pack=poison, label="poison")
    svc = P.serve.PlanService(max_batch=2, max_wait_s=0.0, engine=engine)
    t = svc.submit("t", _payload(rng), plan=plan)
    svc.drain()
    g = P.gather(t.result(0))
    svc.close()
    engine.close()
    return {"fft": {"t": g}}


def s_streaming_no_daemon(P, dims):
    import threading

    plan = P.plan(dims, (8, 6, 4))
    rng = np.random.default_rng(7)
    n_before = threading.active_count()
    engine = P.engine.Engine("stream")
    svc = P.serve.PlanService(max_batch=4, max_wait_s=0.001, engine=engine)
    svc.start()
    us = [_payload(rng) for _ in range(6)]
    tickets = [svc.submit("t", u, plan=plan) for u in us]
    outs = [P.gather(t.result(60)) for t in tickets]
    time.sleep(0.05)
    late_u = _payload(rng)
    late = svc.submit("t", late_u, plan=plan)
    outs.append(P.gather(late.result(60)))
    svc.stop()
    assert threading.active_count() <= n_before + 1 + engine.stats()[
        "workers"]
    assert all(t.name.startswith("pa-engine-stream")
               for t in threading.enumerate()
               if t.name.startswith("pa-") and "stream" in t.name)
    svc.close()
    engine.close()
    return {"fft": {"outs": np.stack(outs)}}


def s_streaming_rearms_after_reform(P, dims):
    plan = P.plan(dims, (8, 6, 4))
    rng = np.random.default_rng(13)
    engine = P.engine.Engine("re-stream")
    svc = P.serve.PlanService(max_batch=4, max_wait_s=0.05, engine=engine)
    svc.start()
    engine.reform()
    t = svc.submit("t", _payload(rng), plan=plan)
    g = P.gather(t.result(60))
    svc.stop()
    svc.close()
    engine.close()
    return {"fft": {"t": g}}


def s_streaming_queued_after_reform(P, dims):
    plan = P.plan(dims, (8, 6, 4))
    rng = np.random.default_rng(19)
    engine = P.engine.Engine("re-queued")
    svc = P.serve.PlanService(max_batch=4, max_wait_s=0.2, engine=engine)
    svc.start()
    t = svc.submit("t", _payload(rng), plan=plan)
    engine.reform()
    g = P.gather(t.result(60))
    svc.stop()
    svc.close()
    assert not engine._reform_cbs
    engine.close()
    return {"fft": {"t": g}}


def s_streaming_full_batch_fast(P, dims):
    plan = P.plan(dims, (8, 6, 4))
    rng = np.random.default_rng(29)
    engine = P.engine.Engine("fullfast")
    svc = P.serve.PlanService(max_batch=2, max_wait_s=5.0, engine=engine)
    for _ in range(2):
        svc.submit("t", _payload(rng), plan=plan)
    svc.drain()
    svc.start()
    t0 = time.monotonic()
    tickets = [svc.submit("t", _payload(rng), plan=plan) for _ in range(2)]
    outs = [P.gather(tk.result(30)) for tk in tickets]
    fast = time.monotonic() - t0 < 2.5
    assert fast
    svc.stop()
    svc.close()
    engine.close()
    return {"fft": {"outs": np.stack(outs)}, "fast": fast}


def s_streaming_quiesced_resume(P, dims):
    plan = P.plan(dims, (8, 6, 4))
    rng = np.random.default_rng(23)
    engine = P.engine.Engine("re-resume")
    svc = P.serve.PlanService(max_batch=4, max_wait_s=0.01, engine=engine)
    svc.start()
    assert engine.quiesce(5)
    t = svc.submit("t", _payload(rng), plan=plan)
    engine.resume()
    g = P.gather(t.result(60))
    svc.stop()
    svc.close()
    engine.close()
    return {"fft": {"t": g}}


def s_step_fails_tickets(P, dims):
    plan = P.plan(dims, (8, 6, 4))
    rng = np.random.default_rng(17)
    engine = P.engine.Engine("strand")
    svc = P.serve.PlanService(max_batch=4, max_wait_s=0.0, engine=engine)
    u = _payload(rng)
    fwd = svc.submit("t", u, plan=plan)
    bwd = svc.submit("t", u, plan=plan, direction="backward")
    engine.close()
    assert svc.step(flush=True) == 2
    errs = []
    for tk in (fwd, bwd):
        assert isinstance(tk.error(), P.eerrors.EngineClosedError)
        errs.append(type(tk.error()).__name__)
    svc.close()
    return {"errors": errs}


def s_elastic_reform_rebuilds_engine(P, dims, d):
    rng = np.random.default_rng(11)
    engine = P.engine.get_engine()
    gen0 = engine.generation
    svc = P.serve.PlanService(max_batch=2, max_wait_s=0.0)
    svc.register_plan("drill", lambda ctx: P.plan(dims, (8, 6, 4)))
    t0 = svc.submit("t", _payload(rng), name="drill")
    svc.drain()
    g0 = P.gather(t0.result(0))
    kv = P.FileKV(str(d / "kv"))
    c0 = P.Coordinator(kv, 0, 1, lease_ttl=5.0, verdict_timeout=20)
    try:
        r = P.elastic.reform(c0, reason="resize", install=False)
        assert engine.generation == gen0 + 1
        assert "engine_quiesce_s" in r.timings
        t1 = svc.submit("t", _payload(rng), name="drill")
        svc.drain()
        g1 = P.gather(t1.result(0))
        r.coordinator.shutdown()
    finally:
        svc.close()
        c0.shutdown()
        P.cluster._reset_for_tests()
    return {"fft": {"t0": g0, "t1": g1}}


def s_real_coalesced_batch(P, dims, d):
    jdir = str(d / "obs")
    P.obs.enable(jdir)
    try:
        plan = P.plan(dims, (8, 6, 4))
        rng = np.random.default_rng(0)
        svc = P.serve.PlanService(max_batch=3, max_wait_s=60.0)
        us = [host(rng, (8, 6, 4)) for _ in range(3)]
        tickets = [svc.submit("acme", u, plan=plan) for u in us]
        assert svc.drain() == 1
        got = []
        for t, u in zip(tickets, us):
            g = P.gather(t.result(5.0))
            np.testing.assert_allclose(g, np.fft.fftn(u), rtol=1e-3,
                                       atol=1e-3)
            got.append(g)
        svc.close()
    finally:
        P.obs.disable()
    events = P.events.read_journal(jdir)
    assert P.schema.lint_journal(events) == []
    reqs = [e for e in events if e["ev"] == "serve.request"]
    minted = [e["trace"] for e in reqs]
    assert len(reqs) == 3 and len(set(minted)) == 3
    disp = [e for e in events if e["ev"] == "serve.dispatch"]
    coal = [e for e in events if e["ev"] == "serve.coalesce"]
    assert len(disp) == 1 and len(coal) == 1
    assert sorted(disp[0]["traces"]) == sorted(minted)
    assert sorted(coal[0]["traces"]) == sorted(minted)
    assert disp[0]["trace"] == disp[0]["traces"][0]
    done = [e for e in events if e["ev"] == "serve.complete"]
    assert sorted(e["trace"] for e in done) == sorted(minted)
    from importlib import import_module

    rf = import_module(P.obs.__name__ + ".requestflow")
    # one rank's journal reconstructs (on a mesh, rank 0's; the others'
    # hold the same requests under their own process ids)
    for tr in (minted if P.rank0() else ()):
        rt, warnings = rf.reconstruct_request(jdir, tr)
        assert rt is not None and warnings == []
        assert rt.fan_in == 3 and rt.outcome == "ok"
        assert P.obs_main(["request", jdir, tr]) == 0
    return {"fft": {"served": np.stack(got)},
            "records": serve_records(P, jdir)}


SCENARIOS = {k: v for k, v in globals().items() if k.startswith("s_")}
