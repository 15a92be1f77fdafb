"""``pa-obs`` — the post-mortem CLI over obs artifacts (the JAX package's
``obs/__main__.py``: the same commands, flags, output and exit codes).

One command instead of hand-written ``jq``: point it at a journal
directory (or a crash bundle) from a drill, a production run, or a
dead mesh, and get the merged cross-rank story.

::

    python -m pencilarrays_tpu_torch.obs <command> ...   # the JAX package: pa-obs

    merge DIR [-o FILE]      merged, causally-ordered journal (JSONL;
                             stdout by default) — rotated segments and
                             torn tails handled, skew corrected
    lint DIR                 schema-lint every record of every rank +
                             print merge warnings; exit 1 on schema
                             errors (warnings alone exit 0: wreckage
                             degrades, it does not fail the reader)
    timeline DIR             human-readable per-(step, epoch) timeline
                             with per-rank activity + offline straggler
                             verdicts
    trace DIR [-o FILE]      Chrome/Perfetto trace_event JSON (default
                             DIR/trace.json) — load at ui.perfetto.dev
    request DIR TRACE_ID     ONE request's causal timeline across
                             router + N mesh journals (schema v6
                             trace ids) with critical-path
                             decomposition; exit 1 if the id appears
                             in no record (warnings alone exit 0)
    requests DIR             index every traced request: tenant,
                             ranks touched, rebinds, total seconds,
                             outcome
    drift DIR                per-hop predicted-vs-measured drift table
                             (mesh_metrics.json when present, else
                             metrics.json)
    bundle PATH              summarize crash bundle(s): manifest,
                             artifacts, epoch, and the merged-timeline
                             pointer into the bundled journal copy

Every command is read-only over the artifacts it is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

__all__ = ["main"]


def _cmd_merge(args) -> int:
    from .timeline import merge_journals

    tl = merge_journals(args.dir, correct_skew=not args.no_skew)
    out = sys.stdout if args.output in (None, "-") else open(
        args.output, "w")
    try:
        for e in tl.events:
            out.write(json.dumps(e, separators=(",", ":")) + "\n")
    finally:
        if out is not sys.stdout:
            out.close()
    for w in tl.warnings:
        print(f"pa-obs: WARNING: {w}", file=sys.stderr)
    return 0


def _cmd_lint(args) -> int:
    from .schema import lint_journal
    from .timeline import merge_journals

    tl = merge_journals(args.dir, correct_skew=not args.no_skew)
    errors = lint_journal(tl.events)
    for w in tl.warnings:
        print(f"WARNING: {w}")
    for e in errors:
        print(f"ERROR: {e}")
    n_ranks = len(tl.ranks)
    print(f"{len(tl.events)} events from {n_ranks} rank(s): "
          f"{len(errors)} schema error(s), {len(tl.warnings)} warning(s)")
    return 1 if errors else 0


def _cmd_timeline(args) -> int:
    from .straggler import detect_from_events
    from .timeline import merge_journals, render

    tl = merge_journals(args.dir, correct_skew=not args.no_skew)
    print(render(tl))
    flags = detect_from_events(tl.events)
    for f in flags:
        print(f"STRAGGLER: rank {f['rank']} on {f['hop']}: "
              f"{f['duration_s']:.6f}s vs baseline "
              f"{f['baseline_s']:.6f}s (excess {f['excess_s']:.6f}s)")
    return 0


def _cmd_trace(args) -> int:
    from .timeline import write_trace

    out = args.output or os.path.join(args.dir, "trace.json")
    trace = write_trace(args.dir, out, correct_skew=not args.no_skew)
    for w in trace["otherData"].get("warnings", []):
        print(f"pa-obs: WARNING: {w}", file=sys.stderr)
    print(f"wrote {len(trace['traceEvents'])} trace events for rank(s) "
          f"{trace['otherData'].get('ranks', [])} to {out} "
          f"(load at https://ui.perfetto.dev)")
    return 0


def _cmd_request(args) -> int:
    from .requestflow import reconstruct_request, render_request

    rt, warnings = reconstruct_request(
        args.dir, args.trace_id, correct_skew=not args.no_skew)
    for w in warnings:
        print(f"pa-obs: WARNING: {w}", file=sys.stderr)
    if rt is None:
        print(f"trace {args.trace_id!r} appears in no record under "
              f"{args.dir} (pa-obs requests lists known ids)")
        return 1
    print(render_request(rt))
    return 0


def _cmd_requests(args) -> int:
    from .requestflow import list_requests, render_index

    summaries, warnings = list_requests(
        args.dir, correct_skew=not args.no_skew)
    for w in warnings:
        print(f"pa-obs: WARNING: {w}", file=sys.stderr)
    print(render_index(summaries))
    return 0


def _drift_rows(report: dict, rank: Optional[str] = None) -> List[tuple]:
    rows = []
    for hop, e in sorted((report or {}).get("hops", {}).items()):
        rows.append((rank if rank is not None else "-", hop,
                     e.get("source"), e.get("predicted_bytes"),
                     e.get("measured_s"), e.get("drift")))
    return rows


def _cmd_drift(args) -> int:
    mesh = os.path.join(args.dir, "mesh_metrics.json")
    single = os.path.join(args.dir, "metrics.json")
    rows: List[tuple] = []
    if os.path.exists(mesh):
        with open(mesh) as f:
            fold = json.load(f)
        for r, snap in sorted((fold.get("per_rank") or {}).items()):
            rows.extend(_drift_rows((snap or {}).get("drift"), rank=r))
        src = mesh
    elif os.path.exists(single):
        with open(single) as f:
            snap = json.load(f)
        rows = _drift_rows(snap.get("drift"))
        src = single
    else:
        print(f"no mesh_metrics.json or metrics.json under {args.dir}")
        return 1
    print(f"drift report from {src}")
    print(f"{'rank':<6} {'drift':>8} {'measured_s':>12} "
          f"{'pred_bytes':>12} {'source':<12} hop")
    for rank, hop, source, nbytes, secs, drift in rows:
        d = f"{drift:.3f}" if isinstance(drift, (int, float)) else "-"
        s = f"{secs:.6f}" if isinstance(secs, (int, float)) else "-"
        print(f"{rank:<6} {d:>8} {s:>12} {nbytes!s:>12} "
              f"{source or '-':<12} {hop}")
    return 0


def _bundle_dirs(path: str) -> List[str]:
    if os.path.isfile(os.path.join(path, "MANIFEST.json")):
        return [path]
    try:
        subs = sorted(os.listdir(path))
    except OSError:
        return []
    return [os.path.join(path, s) for s in subs
            if os.path.isfile(os.path.join(path, s, "MANIFEST.json"))]


def _cmd_bundle(args) -> int:
    dirs = _bundle_dirs(args.path)
    if not dirs:
        print(f"no crash bundle (MANIFEST.json) under {args.path}")
        return 1
    for d in dirs:
        try:
            with open(os.path.join(d, "MANIFEST.json")) as f:
                man = json.load(f)
        except (OSError, ValueError) as e:
            print(f"{d}: unreadable manifest ({e})")
            continue
        print(f"bundle: {d}")
        for key in ("reason", "label", "error", "epoch", "pid", "t_wall"):
            if man.get(key) is not None:
                print(f"  {key}: {man[key]}")
        for name, status in sorted((man.get("artifacts") or {}).items()):
            print(f"  artifact {name}: {status}")
        jdir = os.path.join(d, "journal")
        hint = man.get("timeline_cmd")
        if os.path.isdir(jdir):
            print(f"  timeline: {hint or f'pa-obs timeline {jdir}'}")
        print()
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="pa-obs",
        description="post-mortem CLI over pencilarrays-tpu obs artifacts")
    sub = p.add_subparsers(dest="cmd", required=True)

    def add(name, fn, help_):
        sp = sub.add_parser(name, help=help_)
        sp.set_defaults(fn=fn)
        return sp

    for name, fn, help_ in (
            ("merge", _cmd_merge, "merged causally-ordered journal"),
            ("lint", _cmd_lint, "schema lint + merge warnings"),
            ("timeline", _cmd_timeline, "per-step cross-rank timeline"),
            ("trace", _cmd_trace, "Perfetto trace_event JSON"),
            ("request", _cmd_request,
             "one request's cross-journal causal timeline"),
            ("requests", _cmd_requests, "index every traced request")):
        sp = add(name, fn, help_)
        sp.add_argument("dir", help="journal directory")
        if name == "request":
            sp.add_argument("trace_id",
                            help="schema-v6 trace id (16 hex chars)")
        sp.add_argument("--no-skew-correct", dest="no_skew",
                        action="store_true",
                        help="keep raw per-host wall clocks")
        if name in ("merge", "trace"):
            sp.add_argument("-o", "--output", default=None)
    sp = add("drift", _cmd_drift, "per-hop drift table")
    sp.add_argument("dir", help="directory holding (mesh_)metrics.json")
    sp = add("bundle", _cmd_bundle, "summarize crash bundle(s)")
    sp.add_argument("path", help="a bundle dir, or a dir of bundles")

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
