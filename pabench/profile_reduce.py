"""From a ``torch.profiler`` trace of the measured window to device time
by kernel and by group, the device's busy time (the union of its
operations' intervals, so that overlapping kernels count once) and the
longest idle gaps, each named by the host op that was running in it."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np

GROUPS_FILE = Path(__file__).resolve().parent / "data" / "kernel_groups.json"
WINDOW_SPAN = "pabench.window"

Event = Tuple[str, int, int]   # name, start ns, duration ns


def kernel_groups():
    return [(g["group"], tuple(g["substrings"]))
            for g in json.loads(GROUPS_FILE.read_text())["groups"]]


def group_of(name: str, groups) -> str:
    return next((g for g, words in groups if any(w in name for w in words)),
                "other")


def _ns(e, what: str) -> int:
    f = getattr(e, f"{what}_ns", None)
    return int(f()) if f is not None else int(getattr(e, f"{what}_us")()) * 1000


def split_events(prof) -> Tuple[List[Event], List[Event]]:
    """The device operations (kernels, copies, fills) and the host ops of
    a finished profile.  Annotations that repeat the time of the kernels
    under them (NCCL's ranges, user ranges mirrored on the device) are
    left out."""
    import torch

    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start, dur = _ns(e, "start"), _ns(e, "duration")
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            annotation = getattr(e, "is_user_annotation", lambda: False)()
            if annotation or name.startswith("nccl:"):
                continue
            device.append((name, start, dur))
        else:
            host.append((name, start, dur))
    return device, host


def window_bounds(host: Sequence[Event]) -> Tuple[int, int]:
    for name, start, dur in host:
        if name == WINDOW_SPAN:
            return start, start + dur
    raise ValueError(f"the trace holds no {WINDOW_SPAN!r} span")


def merged(device: Sequence[Event], lo: int, hi: int) -> np.ndarray:
    """Disjoint ``[start, end)`` intervals covering every device
    operation, clipped to ``[lo, hi)``."""
    if not device:
        return np.zeros((0, 2), dtype=np.int64)
    iv = np.array([(s, s + d) for _, s, d in device], dtype=np.int64)
    iv = np.clip(iv[np.argsort(iv[:, 0], kind="stable")], lo, hi)
    iv = iv[iv[:, 1] > iv[:, 0]]
    out = []
    for s, e in iv:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.array(out, dtype=np.int64).reshape(-1, 2)


def busy_ns(intervals: np.ndarray) -> int:
    return int((intervals[:, 1] - intervals[:, 0]).sum())


def device_ops(device: Sequence[Event], top: int = 10):
    """The operations that took most device time: ``[[name, seconds]]``."""
    by: Dict[str, int] = {}
    for name, _, dur in device:
        by[name] = by.get(name, 0) + dur
    ranked = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    return [[name[:120], ns / 1e9] for name, ns in ranked]


def group_seconds(device: Sequence[Event], groups) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for name, _, dur in device:
        g = group_of(name, groups)
        out[g] = out.get(g, 0.0) + dur / 1e9
    return out


def idle_gaps(intervals: np.ndarray, host: Sequence[Event], lo: int,
              hi: int, top: int = 10):
    """The longest stretches of the window with no device operation,
    ``[[what the host ran, seconds]]``: the outermost and innermost host
    op covering the gap's middle."""
    edges = np.concatenate([[lo], intervals.reshape(-1), [hi]])
    gaps = edges.reshape(-1, 2)
    lengths = gaps[:, 1] - gaps[:, 0]
    order = np.argsort(-lengths, kind="stable")[:top]
    ops = [(n, s, d) for n, s, d in host if n != WINDOW_SPAN]
    starts = np.array([s for _, s, _ in ops], dtype=np.int64)
    ends = starts + np.array([d for _, _, d in ops], dtype=np.int64)
    out = []
    for i in order:
        if lengths[i] <= 0:
            break
        mid = (gaps[i, 0] + gaps[i, 1]) // 2
        hit = np.nonzero((starts <= mid) & (ends >= mid))[0]
        if len(hit) == 0:
            what = "no host op"
        else:
            hit = sorted(hit, key=lambda j: -(ends[j] - starts[j]))
            names = [ops[hit[0]][0], ops[hit[-1]][0]]
            what = names[0] if names[0] == names[1] else " > ".join(names)
        out.append([what[:120], int(lengths[i]) / 1e9])
    return out
