"""Run one cell once and print its result line.

A run: set up the cell's program state from the seed and warm it up
(``setup_s``, counted from process start), run its unit of work back to
back for ``--seconds`` of the host clock and wait for the card
(``step_ms``: the window's time over every step dispatched in it), read
the peak of device memory, free the program's state, and compare what
the window produced with the plain reference.  With ``--trace 1`` the
window runs under ``torch.profiler`` and the line carries the per-layer
metrics of ``metrics/`` instead, with a ``breakdown``.

The result is the last line of standard output, one JSON object; the
numbers compared, each beside its limit, are the last lines of standard
error and the last key of that object.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib
import json
import math
import re
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional

from . import profile_reduce as pr

PKG = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
FORBIDDEN = ("jax", "jaxlib", "flax", "pencilarrays_tpu")
GIB = float(1 << 30)


def load(kind: str, name: str) -> dict:
    """``pabench/<kind>/<name>.json``, for a name of the allowed
    characters."""
    if not NAME.match(name):
        raise ValueError(f"not a valid name: {name!r}")
    path = PKG / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def find_cell(name: str):
    """A workload and the configuration it names."""
    wl = load("workloads", name)
    return wl, load("configs", wl["config"])


def driver(kind: str):
    return importlib.import_module(f"pabench.drivers.{kind}")


def metric_readers() -> Dict[str, object]:
    """Every per-layer metric's reader, by its name."""
    return {p.stem: importlib.import_module(f"pabench.metrics.{p.stem}")
            for p in sorted((PKG / "metrics").glob("*.py"))
            if not p.stem.startswith("_")}


def peaks() -> dict:
    return json.loads((PKG / "data" / "peaks.json").read_text())


def forbidden_modules():
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole (``pencilarrays_tpu_torch`` is not
    ``pencilarrays_tpu``)."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


@dataclass
class Window:
    """What a per-layer metric reads from a traced window."""

    steps: int
    seconds: float                  # host clock, first dispatch to sync
    span_s: float                   # the same window on the trace's clock
    busy_s: float                   # union of device operations
    group_s: Dict[str, float]       # device seconds by kernel group
    counters: Dict[str, int]
    transpose_bytes: Optional[int]  # a step's least hop bytes, from shapes
    peaks: dict                     # data/peaks.json


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return out[0] if out else "unknown"


def _counters(k1, tr) -> Dict[str, int]:
    return {"k1_launches": k1.launches, "k1_bytes": k1.bytes_moved,
            **{f"exchange_calls.{op}": n
               for op, n in tr.exchange_calls.items()}}


def _reset_counters(k1, tr):
    k1.launches = 0
    k1.bytes_moved = 0
    for inst in k1.launches_by_instance:
        k1.launches_by_instance[inst] = 0
    for op in tr.exchange_calls:
        tr.exchange_calls[op] = 0


def _ensure_group(dev):
    import torch.distributed as dist
    from pencilarrays_tpu_torch.parallel import distributed

    if not dist.is_initialized():
        distributed.initialize("nccl" if dev.type == "cuda" else "gloo")


def run_cell(wl: dict, cfg: dict, seed: int, seconds: float, trace: bool,
             device: str, t0: float, control: bool = False) -> dict:
    """One run of a cell on ``device``; the result object.  ``t0`` is the
    host clock at process start; ``control`` puts the check's control in
    the program's place."""
    import torch
    from pencilarrays_tpu_torch.ops import permute as k1
    from pencilarrays_tpu_torch.parallel import transpositions as tr
    from torch.profiler import record_function

    parts = {"imports": time.perf_counter() - t0}
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        from pencilarrays_tpu_torch.ops import _build

        _build.build_all(["permute"])
    _ensure_group(dev)
    parts["device_build_group"] = time.perf_counter() - t0 - sum(
        parts.values())
    cell = driver(wl["driver"]).setup(cfg, wl.get("params", {}), seed, dev,
                                      control)
    _sync(dev)
    parts["inputs"] = time.perf_counter() - t0 - sum(parts.values())
    cell.warmup()
    _sync(dev)
    parts["warmup"] = time.perf_counter() - t0 - sum(parts.values())

    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        # one profiling cycle; acc_events keeps torch from warning that a
        # later cycle would drop this one's events
        prof = profile(activities=acts, acc_events=True)
        prof.__enter__()
    _reset_counters(k1, tr)
    _sync(dev)
    setup_s = time.perf_counter() - t0
    span = (record_function(pr.WINDOW_SPAN) if trace
            else contextlib.nullcontext())
    with span:
        start = time.perf_counter()
        deadline = start + seconds
        steps = 0
        while True:
            cell.step()
            steps += 1
            if time.perf_counter() >= deadline:
                break
        _sync(dev)
        window_s = time.perf_counter() - start
    if prof is not None:
        prof.__exit__(None, None, None)
    counters = _counters(k1, tr)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)

    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": int(wl.get("chips", 1)),
                   "memory_peak_bytes": int(peak),
                   "power_limit": (_power_limit() if dev.type == "cuda"
                                   else "none"),
                   "torch": torch.__version__,
                   "cuda": torch.version.cuda}
    if trace:
        metrics, breakdown, busy_s, span_s = _per_layer(
            prof, steps, window_s, counters, cell)
        prof = None
        device_info.update(busy_s=busy_s, window_s=span_s)
    else:
        metrics = {"step_ms": {"value": 1e3 * window_s / steps, "unit": "ms"},
                   "peak_hbm_gib": {"value": peak / GIB, "unit": "GiB"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
        breakdown = None

    cell.release()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_check = time.perf_counter()
    got = cell.check()
    parts["check_after_window"] = time.perf_counter() - t_check
    del cell
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    limits = wl["limits"]
    checks = {name: {"value": float(got[name]),
                     "limit": float(limits[name])} for name in sorted(got)}
    failed = sum(1 for c in checks.values()
                 if not (math.isfinite(c["value"])
                         and c["value"] <= c["limit"]))
    missing = sorted(set(limits) - set(got))
    result = {"correct": failed == 0 and not missing, "attempted": steps,
              "failed": failed + len(missing), "metrics": metrics,
              "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["setup_parts_s"] = parts
    result["checks"] = checks
    return result


def _per_layer(prof, steps, window_s, counters, cell):
    device_ev, host_ev = pr.split_events(prof)
    lo, hi = pr.window_bounds(host_ev)
    intervals = pr.merged(device_ev, lo, hi)
    busy_s = pr.busy_ns(intervals) / 1e9
    w = Window(steps=steps, seconds=window_s, span_s=(hi - lo) / 1e9,
               busy_s=busy_s,
               group_s=pr.group_seconds(device_ev, pr.kernel_groups()),
               counters=counters, transpose_bytes=cell.transpose_bytes,
               peaks=peaks())
    metrics = {}
    for name, mod in metric_readers().items():
        value = mod.read(w)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": mod.UNIT}
    breakdown = {"device_ops": pr.device_ops(device_ev),
                 "idle_gaps": pr.idle_gaps(intervals, host_ev, lo, hi)}
    return metrics, breakdown, busy_s, w.span_s


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def report(result: dict) -> None:
    """The numbers compared on standard error, then the result line."""
    print("set-up and check, s: " + json.dumps(result["setup_parts_s"]),
          file=sys.stderr, flush=True)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


def main(t0: float, argv=None) -> int:
    """The command: ``t0`` is the host clock at process start."""
    args = parse_args(argv)
    wl, cfg = find_cell(args.workload)
    import torch

    chips = int(wl.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"pabench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(wl, cfg, args.seed, args.seconds, bool(args.trace),
                      "cuda", t0)
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    found = forbidden_modules()
    if found:
        print(f"pabench: the run loaded {found}, which the benchmark of "
              f"the port may not load", file=sys.stderr)
        return 3
    report(result)
    return 0
