"""Worker for the port's fleet drills (the JAX package's
``tests/fleet_worker.py``, ported).

One OS process = one back-end MESH: a one-rank process on a ``(1, 1)``
topology (on the CPU, or on the card) wrapping a
:class:`~pencilarrays_tpu_torch.serve.PlanService` (``max_batch=4``) in a
:class:`~pencilarrays_tpu_torch.fleet.MeshWorker`, joined to the router
ONLY through a shared ``FileKV`` directory.  It registers two named
plans: ``minnow`` and ``whale`` — the JAX worker's c2c ``(8, 6, 4)`` and
``(16, 12, 8)`` by default, or r2c float32 cubes of edge ``whale_n`` and
``minnow_n`` when those are given (``chip_smoke.py`` phase 5h: 512^3 and
128^3).  It advertises both plans as warm, as the JAX worker does, or
only those named in ``warm`` (comma-separated): the router's placement
prefers a mesh warm for a request's plan.

Identity is the environment: the launcher's
``PENCILARRAYS_TPU_FLEET_MESH=<k>`` lets one fault spec shared by every
process address a single mesh (``fleet.route:kill%mesh1@4`` SIGKILLs
exactly mesh 1 as it takes its 4th routed request), and
``PENCILARRAYS_TPU_CLUSTER_RANK=<k>`` puts each mesh's journal in its own
``journal.r<k>.jsonl`` for the cross-process timeline merge.

It prints ``READY mesh=<k> pid=<pid>`` once serving, one ``WIRE <json>``
line per routed request it answered (the seconds of its wire parts: the
request's decode, the result's encode and its KV write), and on its way
out (a stop key, or ``max_seconds``) ``EXITED mesh=<k> handled=<n>``,
then ``CERTIFY <json>`` (``PlanService.certify`` of its resident
variants: each variant's predicted peak beside the process's measured
peak), ``STATS <json>`` (peak device memory above the idle service, the
plans' graph pool bytes), ``K1=<launches> <by instance>`` and
``K1_CLASSES=<json>``.

Usage::

    python torch_fleet_worker.py <kvroot> <mesh> <tmpdir> [max_seconds]
        [device] [whale_n minnow_n] [warm]
"""

import json
import os
import sys
import time


def _lists(x):
    return [_lists(i) for i in x] if isinstance(x, tuple) else x


def _timed(wire, name, sink, tid_of):
    """``wire.<name>`` timed into ``sink[tid]`` (a harness probe: the
    codec itself is untouched)."""
    fn = getattr(wire, name)

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        sink[tid_of(args, out)] = time.perf_counter() - t0
        return out

    setattr(wire, name, timed)


def main():
    kvroot, mesh, tmpdir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    max_seconds = float(sys.argv[4]) if len(sys.argv) > 4 else 60.0
    device = sys.argv[5] if len(sys.argv) > 5 else "cpu"
    sizes = (int(sys.argv[6]), int(sys.argv[7])) if len(sys.argv) > 7 \
        else None
    warm = (sys.argv[8].split(",") if len(sys.argv) > 8
            else ["minnow", "whale"])
    # mesh identity BEFORE importing anything heavy: the %mesh fault
    # selector and the journal attribution are env-read
    os.environ["PENCILARRAYS_TPU_FLEET_MESH"] = str(mesh)
    os.environ.setdefault("PENCILARRAYS_TPU_CLUSTER_RANK", str(mesh))
    os.environ.setdefault("PENCILARRAYS_TPU_OBS",
                          os.path.join(tmpdir, "obs"))
    ttl = float(os.environ.get("PA_FLEET_TEST_TTL", "2.0"))
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch

    import pencilarrays_tpu_torch as pat
    from pencilarrays_tpu_torch.cluster.kv import FileKV
    from pencilarrays_tpu_torch.fleet import MeshWorker, wire
    from pencilarrays_tpu_torch.ops import permute as k1
    from pencilarrays_tpu_torch.serve import PlanService

    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"mesh {mesh}: no CUDA device")
    torch.set_num_threads(max(1, min(4, os.cpu_count() or 1)))
    topo = pat.Topology((1, 1), device=device)
    svc = PlanService(max_batch=4, max_wait_s=0.0)
    if sizes is None:
        svc.register_plan("minnow", lambda ctx: pat.PencilFFTPlan(
            topo, (8, 6, 4)))
        svc.register_plan("whale", lambda ctx: pat.PencilFFTPlan(
            topo, (16, 12, 8)))
    else:
        for name, n in (("whale", sizes[0]), ("minnow", sizes[1])):
            svc.register_plan(name, lambda ctx, n=n: pat.PencilFFTPlan(
                topo, (n, n, n), real=True, dtype=torch.float32))
    kv = FileKV(kvroot)
    decode, encode = {}, {}
    _timed(wire, "decode_request", decode, lambda a, out: out["ticket"])
    _timed(wire, "encode_result", encode, lambda a, out: a[0])
    plain_set = kv.set

    def timed_set(key, value):
        t0 = time.perf_counter()
        plain_set(key, value)
        if "/res/" in key:
            tid = wire.ticket_id_of(key)
            print("WIRE " + json.dumps({
                "tid": tid, "decode_s": decode.get(tid),
                "encode_s": encode.get(tid),
                "kv_write_s": time.perf_counter() - t0,
                "bytes": len(value)}), flush=True)

    kv.set = timed_set
    worker = MeshWorker(kv, mesh, service=svc, ttl=ttl)
    worker.prewarm(warm)
    if device == "cuda":
        torch.cuda.synchronize()
        idle = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    k1.launches = 0
    for inst in k1.launches_by_instance:
        k1.launches_by_instance[inst] = 0
    k1.recorded = {}
    worker.start()
    print(f"READY mesh={mesh} pid={os.getpid()}", flush=True)
    try:
        worker.run(poll_s=0.01, max_seconds=max_seconds)
    finally:
        print(f"EXITED mesh={mesh} handled={worker.handled}", flush=True)
    launches = (k1.launches, dict(k1.launches_by_instance))
    classes = [[list(_lists(c)), n] for c, n in (k1.recorded or {}).items()]
    stats = {"mesh": mesh, "handled": worker.handled}
    limit = 1 << 30
    if device == "cuda":
        torch.cuda.synchronize()
        stats["peak_above_idle_bytes"] = \
            torch.cuda.max_memory_allocated() - idle
        stats["pools"] = {f"{k[0]}:{list(k[1])}": v
                          for k, v in svc.registry.graph_info().items()}
        limit = torch.cuda.get_device_properties(0).total_memory // 2
    report = svc.certify(hbm_limit=limit)
    print("CERTIFY " + json.dumps({
        "ok": report["ok"], "certified": report["certified"],
        "hbm_limit": limit,
        "measured_peak_bytes": stats.get("peak_above_idle_bytes"),
        "variants": [{k: r.get(k) for k in (
            "target", "extra_dims", "outcome", "ops", "peak_hbm_bytes")}
            for r in report["plans"]]}), flush=True)
    print("STATS " + json.dumps(stats), flush=True)
    print(f"K1={launches[0]} {json.dumps(launches[1])}", flush=True)
    print("K1_CLASSES=" + json.dumps(classes), flush=True)
    svc.close()


if __name__ == "__main__":
    main()
