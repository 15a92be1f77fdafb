"""Observability, worked through: journal, metrics, drift and capture.
One small distributed run with the flight recorder armed — an FFT plan
and its hops, a checkpoint cycle that survives an injected open error,
a measured hop reconciled against the byte model (on a 2-D topology),
a profiler capture stamped with the plan — ending with the artifacts a
production job ships: the JSONL event timeline (lint-clean), the metrics
snapshot (with the drift report and the bench noise floor) and a
Prometheus textfile, then ``pa-obs timeline`` and ``pa-obs trace`` over
them.  The twin of the JAX package's ``examples/observability_demo.py``::

    python -m pencilarrays_tpu_torch.examples.observability_demo [--device cpu]

The artifacts stay in ``workdir`` (default: a new temporary directory).
"""

from __future__ import annotations

import collections
import os
import tempfile

import numpy as np
import torch.distributed as dist

import pencilarrays_tpu_torch as pat
from pencilarrays_tpu_torch import obs
from pencilarrays_tpu_torch.obs.__main__ import main as pa_obs
from pencilarrays_tpu_torch.resilience import (CheckpointManager,
                                               RetryPolicy, faults)

from . import _launch

SIZES = {"shape": (512, 512, 512)}
SEED = 0            # the JAX script's numpy seed


def run(device=None, shape=SIZES["shape"], workdir=None) -> dict:
    shape = tuple(shape)
    if workdir is None:
        box = [tempfile.mkdtemp(prefix="pa_obs_demo_")
               if _launch.is_root() else None]
        if dist.is_initialized() and dist.get_world_size() > 1:
            dist.broadcast_object_list(box, src=0)
        workdir = box[0]
    # the demo's own journal (or the script's PENCILARRAYS_TPU_OBS), and
    # the configuration before it again after it
    with obs.journal_to(os.path.join(workdir, "obs")):
        return _demo(device, shape, workdir)


def _demo(device, shape, workdir) -> dict:
    # -- a plan and a few hops: plan.build, hop and auto.verdict records
    P = pat.distributed.process_count()
    topo = pat.Topology((2, 4) if P == 8 else (P,), device=device)
    plan = pat.PencilFFTPlan(topo, shape, real=True, pipeline=2)
    u = plan.allocate_input()
    plan.backward(plan.forward(u))

    # -- a checkpoint cycle with an injected transient error: the retry
    # and fault records land in the journal, the commit is fsync'd
    pen = plan.input_pencil
    state = {"u": pat.PencilArray.from_global(
        pen, np.random.default_rng(SEED).standard_normal(shape)
        .astype(np.float32))}
    mgr = CheckpointManager(
        os.path.join(workdir, "ckpts"), keep=2,
        retry=RetryPolicy(max_attempts=3, base_delay=0.01))
    with faults.active("io.open:error*1@1"):   # the first open fails
        mgr.save(0, state)
    restored = mgr.restore().read("u", pen)
    if not bool((restored.data == state["u"].data).all()):
        raise AssertionError("the restored state differs from the saved")

    # -- reconcile the byte model against a real measurement
    out = {"shape": list(shape), "topology": list(topo.dims)}
    if len(topo.dims) > 1:
        from pencilarrays_tpu_torch.obs.drift import measure_transpose

        m = measure_transpose(pat.PencilArray.zeros(pen),
                              pen.replace(decomp_dims=(0, 2)),
                              k0=1, k1=4, repeats=2)
        out.update(measured_hop=m["hop"],
                   predicted_bytes=m["predicted_bytes"],
                   measured_seconds=m["seconds"])

    # -- a profiler capture stamped with the plan's metadata
    with obs.profile(os.path.join(workdir, "capture"), plan=plan,
                     note="observability demo"):
        plan.forward(u)

    # -- the artifacts
    events = obs.read_journal()
    lint = obs.lint_journal(events)
    if lint:
        raise AssertionError(f"the journal does not lint clean: {lint}")
    snap = obs.snapshot()
    jdir = obs.journal_dir()
    out.update(
        journal_dir=jdir, events=len(events),
        event_kinds=dict(sorted(collections.Counter(
            e["ev"] for e in events).items())),
        lint_clean=True,
        drift_hops=sorted(snap["drift"]["hops"]),
        benchtime=snap["benchtime"],
        snapshot=obs.write_snapshot(),
        prometheus=obs.write_prometheus(os.path.join(workdir,
                                                     "metrics.prom")))
    # the post-mortem CLI (pa-obs-torch) over the same artifacts
    if _launch.is_root():
        if pa_obs(["timeline", jdir]) != 0:
            raise AssertionError("pa-obs timeline failed")
        trace = os.path.join(workdir, "trace.json")
        if pa_obs(["trace", jdir, "-o", trace]) != 0:
            raise AssertionError("pa-obs trace failed")
        out["trace"] = trace
    return out


def main(argv=None) -> int:
    return _launch.main(__spec__.name, __doc__, SIZES, argv)


if __name__ == "__main__":
    raise SystemExit(main())
