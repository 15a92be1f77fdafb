"""Device time by the program span that launched it.

Each device operation of the traced window (kernel, copy, fill) is put
down to the innermost span of ``data/spans.json`` that was open when the
host launched it: the operation's correlation id names the runtime call
that launched it (``cudaLaunchKernel``, ``cudaMemcpyAsync``, ...), and
the spans open at that call's start on its thread are the launching
code's sections.  All three events are on the profiler's one clock.  An
operation whose launch no listed span encloses, or whose launch the trace
lacks, is unspanned.

The per-layer metrics read this through :func:`of`.  ``harness.Window``
carries no trace events, so :func:`of` takes the finished profile from
the frame of ``harness._per_layer``, the call that is reading the
metrics, by its parameter ``prof`` (a CPU test holds both names).  A
trace with no listed span in it (a program without spans) gives
``None``, and so does any failure to read the trace: a metric is then
left out of the line, never raised.
"""

from __future__ import annotations

import json
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from . import profile_reduce as pr

SPANS_FILE = Path(__file__).resolve().parent / "data" / "spans.json"
UNSPANNED = "unspanned"

Op = Tuple[str, int, int, int]        # name, start ns, duration ns, corr
Launch = Tuple[int, int]              # start ns, thread
SpanEvent = Tuple[str, int, int, int]  # name, start ns, end ns, thread


def span_layers() -> Dict[str, str]:
    """Every listed span's layer, by the span's name."""
    return {s["name"]: s["layer"]
            for s in json.loads(SPANS_FILE.read_text())["spans"]}


@dataclass
class Attribution:
    """Device seconds and operation counts of a window, by the innermost
    listed span of each operation's launch (``UNSPANNED`` where none),
    and by that span and the operation's kernel group."""

    spans_seen: int = 0                  # listed span ranges in the window
    total_s: float = 0.0                 # every device operation's time
    ops: int = 0
    seconds: Dict[str, float] = field(default_factory=dict)
    count: Dict[str, int] = field(default_factory=dict)
    group_seconds: Dict[Tuple[str, str], float] = field(default_factory=dict)
    # seconds of the operations with the span anywhere on their stack
    under_seconds: Dict[str, float] = field(default_factory=dict)

    def add(self, stack: Tuple[str, ...], group: str, seconds: float):
        inner = stack[-1] if stack else UNSPANNED
        self.total_s += seconds
        self.ops += 1
        self.seconds[inner] = self.seconds.get(inner, 0.0) + seconds
        self.count[inner] = self.count.get(inner, 0) + 1
        key = (inner, group)
        self.group_seconds[key] = self.group_seconds.get(key, 0.0) + seconds
        for name in set(stack):
            self.under_seconds[name] = (self.under_seconds.get(name, 0.0)
                                        + seconds)


def _stacks(spans: Sequence[SpanEvent], launches: Dict[int, Launch]
            ) -> Dict[int, Tuple[str, ...]]:
    """The listed spans open at each launch on the launch's thread,
    outermost first, by the launch's correlation id.  Spans on one thread
    nest, so a sweep in time order with a stack finds them."""
    by_thread: Dict[int, List[SpanEvent]] = {}
    for s in spans:
        by_thread.setdefault(s[3], []).append(s)
    todo: Dict[int, List[Tuple[int, int]]] = {}
    for corr, (t, tid) in launches.items():
        if tid in by_thread:
            todo.setdefault(tid, []).append((t, corr))
    out: Dict[int, Tuple[str, ...]] = {}
    for tid, calls in todo.items():
        ss = sorted(by_thread[tid], key=lambda s: (s[1], -s[2]))
        stack: List[SpanEvent] = []
        i = 0
        for t, corr in sorted(calls):
            while i < len(ss) and ss[i][1] <= t:
                while stack and stack[-1][2] < ss[i][1]:
                    stack.pop()
                stack.append(ss[i])
                i += 1
            while stack and stack[-1][2] < t:
                stack.pop()
            # spans nest, so every span left on the stack encloses t
            out[corr] = tuple(s[0] for s in stack)
    return out


def attribute(ops: Sequence[Op], launches: Dict[int, Launch],
              spans: Sequence[SpanEvent], groups) -> Attribution:
    """Every operation of ``ops`` put down once to the innermost listed
    span of its launch (``launches``: correlation id to start and thread;
    ``spans``: the listed spans' ranges), with its kernel group."""
    stacks = _stacks(spans, launches)
    att = Attribution(spans_seen=len(spans))
    for name, _, dur, corr in ops:
        att.add(stacks.get(corr, ()), pr.group_of(name, groups), dur / 1e9)
    return att


def from_profile(prof) -> Attribution:
    """The attribution of the window of a finished ``torch.profiler``
    trace: the operations that start inside the harness's window span.
    The device operations are those ``profile_reduce.split_events``
    keeps."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    listed = set(span_layers())
    ops: List[Op] = []
    launches: Dict[int, Launch] = {}
    spans: List[SpanEvent] = []
    lo = hi = None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start, dur = pr._ns(e, "start"), pr._ns(e, "duration")
        if e.device_type() == cuda:
            annotation = getattr(e, "is_user_annotation", lambda: False)()
            if not (annotation or name.startswith("nccl:")):
                ops.append((name, start, dur, int(e.correlation_id())))
        elif name == pr.WINDOW_SPAN:
            lo, hi = start, start + dur
        elif name in listed:
            spans.append((name, start, start + dur,
                          int(e.start_thread_id())))
        elif name.startswith("cu"):    # cudaLaunchKernel, cudaMemcpyAsync, ...
            corr = int(e.correlation_id())
            if corr and corr not in launches:
                launches[corr] = (start, int(e.start_thread_id()))
    if lo is None:
        raise ValueError(f"the trace holds no {pr.WINDOW_SPAN!r} span")
    ops = [o for o in ops if lo <= o[1] <= hi]
    spans = [s for s in spans if s[2] >= lo and s[1] <= hi]
    return attribute(ops, launches, spans, pr.kernel_groups())


_cache: Optional[Tuple[object, Optional[Attribution]]] = None


def _profile_being_read():
    f = sys._getframe(1)
    while f is not None:
        if (f.f_code.co_name == "_per_layer"
                and f.f_globals.get("__name__") == "pabench.harness"):
            return f.f_locals.get("prof")
        f = f.f_back
    return None


def of(w) -> Optional[Attribution]:
    """The attribution of the window ``w`` that a metric reads, computed
    once a window; ``None`` where the trace holds no listed span or cannot
    be read (module docstring)."""
    global _cache
    if _cache is not None and _cache[0] is w:
        return _cache[1]
    att = None
    try:
        prof = _profile_being_read()
        if prof is not None:
            att = from_profile(prof)
    except Exception as e:  # noqa: BLE001 - a metric is left out, not raised
        print(f"pabench: no span attribution: {type(e).__name__}: {e}",
              file=sys.stderr)
        att = None
    if att is not None and not att.spans_seen:
        att = None
    _cache = (w, att)
    return att


def per_step_ms(w, seconds: float) -> Optional[float]:
    """Device ms a step, or ``None`` where there is none."""
    return 1e3 * seconds / w.steps if seconds > 0 else None

