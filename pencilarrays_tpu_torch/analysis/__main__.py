"""``pa-lint`` of the port — static verification gate over the repo and
its programs (the JAX package's ``python -m pencilarrays_tpu.analysis``).

::

    python -m pencilarrays_tpu_torch.analysis [ROOT] [options]

    ROOT                repo root to lint (default: auto-detect from
                        CWD, falling back to the installed package's
                        parent)
    --allowlist FILE    allowlist path (default: ROOT/pa-lint-torch.allow)
    --no-spmd           skip pillar 1 (the collective-schedule sweep;
                        pillar 2's AST lint is pure source analysis and
                        always runs)
    --devices N         ranks of the sweep (default 8)
    --device cuda|cpu   where the sweep's ranks run (default cuda: one
                        rank per card, at most N; cpu: N gloo ranks)
    --json              machine-readable findings + sweep report

Exit status: 0 when the AST lint has no findings outside the
allowlist AND every sweep check verifies; 1 otherwise.

Pillar 1 runs the plan-type matrix (slab/pencil x c2c/r2c x
unbatched/batched, plus a routed reshard with donation + peak-memory
bounds and a guard-on-vs-off consistency pin) on a topology of 4 (and 8)
ranks, tracing each program as it runs
(:mod:`~pencilarrays_tpu_torch.analysis.spmd`) and proving its
collective schedule equals the ``collective_costs`` prediction.  With
fewer than 4 ranks (one card) the sweep reports ``skipped``, as the JAX
package's does below a 4-device mesh; on a machine without a card,
``--device cuda`` fails the sweep (ask for ``--device cpu``).  Pillar 2
is :mod:`pencilarrays_tpu_torch.analysis.lint`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import List, Optional

__all__ = ["main"]


def _find_root(start: Optional[str]) -> str:
    """The repo root: an explicit argument, else the first ancestor of
    CWD containing ``pencilarrays_tpu_torch/``, else the installed
    package's parent directory."""
    if start:
        return os.path.abspath(start)
    d = os.getcwd()
    while True:
        if os.path.isdir(os.path.join(d, "pencilarrays_tpu_torch")):
            return d
        parent = os.path.dirname(d)
        if parent == d:
            break
        d = parent
    import pencilarrays_tpu_torch

    return os.path.dirname(os.path.dirname(
        os.path.abspath(pencilarrays_tpu_torch.__file__)))


def _sweep_rank(device: str) -> Optional[List[dict]]:
    """Pillar 1 on one rank of the pool (every rank runs every check —
    a trace is a collective); rank 0's check records, None elsewhere."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from pencilarrays_tpu_torch import Pencil, PencilFFTPlan, Topology
    from pencilarrays_tpu_torch import guard
    from pencilarrays_tpu_torch.analysis import spmd
    from pencilarrays_tpu_torch.analysis.errors import AnalysisError
    from pencilarrays_tpu_torch.parallel.routing import plan_reshard_route

    world = dist.get_world_size()
    rank = dist.get_rank()
    results: List[dict] = []

    def run(target, fn):
        try:
            rec = fn()
            rec = {"target": target, "outcome": "ok", **(rec or {})}
        except AnalysisError as e:
            rec = {"target": target, "outcome": type(e).__name__,
                   "error": str(e)}
        results.append(rec)

    from pencilarrays_tpu_torch.parallel.topology import axis_lines

    dev = None if device == "cuda" else "cpu"
    shape = (8, 8, 4)

    def sub_topology(dims):
        # a topology over the first prod(dims) ranks: every rank makes
        # the same group calls in the same order (new_group is
        # collective), the others mirror the topology's sub-groups
        n = int(np.prod(dims))
        if n == world:
            return Topology(dims, device=dev)
        group = dist.new_group(list(range(n)))
        if rank < n:
            return Topology(dims, device=dev, group=group)
        for axis in range(len(dims)):
            for line in axis_lines(dims, axis):
                dist.new_group(list(line))
        return None

    topos = {dims: sub_topology(dims) for dims in ((4,), (2, 2))}
    topo8 = sub_topology((2, 4)) if world >= 8 else None
    if rank < 4:
        # slab/pencil x c2c/r2c x unbatched/batched — forward AND backward
        for dims, real in (((4,), False), ((4,), True),
                           ((2, 2), False), ((2, 2), True)):
            kind = f"{'slab' if len(dims) == 1 else 'pencil'}/" \
                   f"{'r2c' if real else 'c2c'}"
            plan = PencilFFTPlan(topos[dims], shape, real=real)
            for extra in ((), (3,)):
                run(f"plan {kind} batch={extra}",
                    lambda p=plan, e=extra: {
                        "ops": len(spmd.verify_plan(p, e, "forward")),
                        "bwd_ops": len(spmd.verify_plan(p, e,
                                                        "backward"))})
        # batched-vs-unbatched amortization: count x1, bytes xB
        plan = PencilFFTPlan(topos[(2, 2)], shape, dtype=torch.complex64)
        run("consistency batched-vs-unbatched",
            lambda: spmd.verify_consistent(
                spmd.trace_plan(plan, ()), spmd.trace_plan(plan, (3,)),
                bytes_ratio=3))
    rtopo = topo8 if topo8 is not None else topos[(2, 2)]
    if rtopo is not None:
        # routed reshard: schedule + peak-memory bound + donation
        rshape = (16, 12, 8)
        pin = Pencil(rtopo, rshape, (1, 2))
        dest = Pencil(rtopo, rshape, (0, 1))
        route = plan_reshard_route(pin, dest, (), torch.float32)
        if route.hops:
            run("route schedule", lambda: {
                "ops": len(spmd.verify_route(route))})
            run("route hbm-bound", lambda: {
                "peak_hbm_bytes": spmd.verify_hbm(
                    route, 1 << 30, source="route")})
            run("route donation", lambda: spmd.verify_donation(
                spmd.trace_route(route, donate=True)))
        # guard-on vs guard-off hops: the same exchange collectives
        p2 = Pencil(rtopo, rshape, (0, 2))

        def _guard_consistency():
            off = spmd.trace_transpose(pin, p2, (), np.float32)
            with tempfile.TemporaryDirectory() as d:
                guard.enable(d)
                try:
                    on = spmd.trace_transpose(pin, p2, (), np.float32)
                finally:
                    guard._reset_for_tests()
            spmd.verify_consistent(off, on)

        run("consistency guard-on-vs-off", _guard_consistency)
    return results if rank == 0 else None


def _run_spmd_sweep(n_ranks: int, device: str = "cuda") -> List[dict]:
    """Pillar 1: the plan-type verification matrix on ``n_ranks``
    ranks.  Each entry is a check record (``{"target", "outcome",
    ...}``); outcomes other than ``ok``/``skipped`` fail the gate."""
    import importlib

    if device == "cuda":
        import torch

        if not torch.cuda.is_available():
            return [{"target": "spmd-sweep", "outcome": "error",
                     "reason": "no CUDA device: pass --device cpu for "
                               "gloo ranks on the CPU"}]
        n_ranks = min(n_ranks, torch.cuda.device_count())
    if n_ranks < 4:
        return [{"target": "spmd-sweep", "outcome": "skipped",
                 "reason": f"{n_ranks} rank(s) available; the sweep "
                           f"needs a topology of >= 4 ranks"}]
    from pencilarrays_tpu_torch.parallel.distributed import spawn

    # the rank function by its importable name (this module runs as
    # __main__ under ``python -m``)
    me = importlib.import_module("pencilarrays_tpu_torch.analysis.__main__")
    out = spawn(me._sweep_rank, n_ranks, device,
                backend="nccl" if device == "cuda" else "gloo",
                timeout_s=600.0)
    return out[0]


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="pa-lint",
        description="static SPMD schedule verifier + repo invariant "
                    "linter of the port (see docs/StaticAnalysis.md)")
    ap.add_argument("root", nargs="?", default=None,
                    help="repo root (default: auto-detect)")
    ap.add_argument("--allowlist", default=None,
                    help="allowlist file (default: "
                         "ROOT/pa-lint-torch.allow)")
    ap.add_argument("--no-spmd", action="store_true",
                    help="skip the collective-schedule sweep")
    ap.add_argument("--devices", type=int, default=8,
                    help="ranks of the sweep")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the sweep's ranks run")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output")
    args = ap.parse_args(argv)

    from .lint import Allowlist, run_lint

    root = _find_root(args.root)
    allowlist = (Allowlist.load(args.allowlist)
                 if args.allowlist else None)
    findings, allowlist = run_lint(root, allowlist)

    sweep: List[dict] = []
    if not args.no_spmd:
        sweep = _run_spmd_sweep(args.devices, args.device)
    sweep_failures = [r for r in sweep
                      if r["outcome"] not in ("ok", "skipped")]

    if args.json:
        print(json.dumps({
            "root": root,
            "findings": [{"check": f.check, "path": f.path,
                          "line": f.line, "ident": f.ident,
                          "message": f.message} for f in findings],
            "allowlisted": sorted(allowlist.entries),
            "unused_allowlist": allowlist.unused(),
            "spmd": sweep,
        }, indent=1))
    else:
        for f in findings:
            print(str(f))
        for key in allowlist.unused():
            print(f"pa-lint: WARNING: unused allowlist entry: {key}",
                  file=sys.stderr)
        for r in sweep:
            status = r["outcome"].upper() if r["outcome"] not in (
                "ok", "skipped") else r["outcome"]
            detail = r.get("error") or r.get("reason") or ""
            print(f"spmd: {status:8s} {r['target']}"
                  + (f" — {detail}" if detail else ""))
        nf, ns = len(findings), len(sweep_failures)
        ok = "clean" if not (nf or ns) else "FAILED"
        print(f"pa-lint: {ok}: {nf} lint finding(s), "
              f"{ns} sweep failure(s), "
              f"{len(allowlist.entries)} allowlisted")
    return 1 if (findings or sweep_failures) else 0


if __name__ == "__main__":
    sys.exit(main())
