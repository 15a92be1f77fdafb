"""Deterministic fault injection for the distributed runtime.

PyTorch counterpart of the JAX package's ``resilience/faults.py``: the
same points, rule grammar, modes and deterministic hit counters, read
from the same environment variable, so one spec arms both packages.
Two things differ: ``%rank<k>`` matches the ``torch.distributed``
rank (0 without a process group), and ``%mesh<k>`` never matches until
the fleet layer is ported (a process that is no mesh worker answers -1,
as in the JAX package).  Firings are journaled as ``fault`` records when
observability is on.  The port consults ``io.*``, ``ckpt.*``,
``dist.initialize``, ``barrier`` and ``hop.exchange``; the other points
parse and wait for their layers.

The I/O drivers, the checkpoint manager and ``parallel/distributed.py``
consult named **injection points** at their failure-critical moments, so
tests (and chaos drills) can simulate torn writes, crash-before-commit
and transient ``OSError`` storms *without monkeypatching internals* —
and so a worker subprocess can be killed mid-write purely through its
environment.

Registered points (see ``docs/Resilience.md``):

========================  ====================================================
``io.open``               driver ``open`` (before the file is touched)
``io.write_block``        one per-shard block about to hit the data file
``io.flush_meta``         a sidecar/metadata flush (the commit point of a
                          driver-level write)
``ckpt.commit``           the checkpoint manager about to commit (rename +
                          COMMIT marker)
``ckpt.restore``          a dataset just restored from a checkpoint
                          (``corrupt`` pokes the restored array)
``dist.initialize``       the coordinator connection inside
                          ``distributed.initialize``
``barrier``               ``sync_global_devices`` (ctx carries the name)
``hop.exchange``          an eager transpose / routed-reshard dispatch
                          (``corrupt`` pokes the hop's output — the SDC
                          drill the ``guard`` probes must catch)
``serve.submit``          the plan service's admission boundary (every
                          ``submit``/``submit_reshard``, before quota/
                          SLO checks — ``error`` fails THIS submitter
                          typed, ``delay`` drags admission: the
                          overload and flaky-client drills)
``fleet.route``           the fleet's routed-admission path: once in
                          the router's ``submit`` and once on the
                          back-end mesh as it takes the routed
                          request — with ``%mesh<k>`` one shared spec
                          kills/delays/errors exactly ONE mesh's
                          admission path (the whole-mesh chaos drill)
``kv.get``                one KV wire read (each ``try_get`` and each
                          poll of a blocking ``get``, both backends) —
                          the ``drop``/``partition`` surface: a
                          partitioned rank's reads find nothing, so
                          its waits run out typed
``kv.set``                one KV wire write (``set``/``set_if``/
                          ``delete``, both backends) — ``drop``
                          silently loses the write, ``partition``
                          raises it unreachable; ``%rank<k>`` on only
                          one of ``kv.get``/``kv.set`` expresses an
                          *asymmetric* partition
========================  ====================================================

Rules are **counter-based, never random** — the same spec replays the
same failure.  Spec grammar (comma/semicolon-separated)::

    point:mode[%rank<k>|%mesh<k>][*times][@nth]

* ``mode`` — ``error`` (raise :class:`InjectedFault`), ``kill``
  (``SIGKILL`` this process: the un-catchable crash), ``torn``
  (cooperative: the call site writes a partial block, then dies),
  ``corrupt`` (cooperative: the call site applies the deterministic
  counter-addressed bitflip/NaN poke of
  ``guard.integrity.corrupt_block`` — silent data corruption on
  demand, so chaos tests can assert typed-error-or-bit-identical,
  never garbage), ``delay`` (sleep
  ``PENCILARRAYS_TPU_FAULTS_DELAY_S`` seconds — default 0.25 — at the
  point, then proceed normally: the deterministic *straggler*, e.g.
  ``hop.exchange:delay%rank1`` makes rank 1 drag every exchange
  without changing any value; guard/cluster semantics are untouched,
  which is exactly what the straggler-detection drill needs),
  ``drop`` (cooperative, KV wire only: the addressed operation is
  *silently lost* — a dropped read misses, a dropped write returns
  normally having written nothing: the lost-update drill), or
  ``partition`` (cooperative, KV wire only: the store is unreachable
  for the addressed process — reads find nothing until their bounded
  wait runs out typed, writes raise ``ConsensusTimeoutError``
  immediately.  ``kv.get:partition%rank1,kv.set:partition%rank1``
  cuts rank 1 off the wire entirely; arming only one direction
  expresses an asymmetric partition).
* ``%rank<k>`` — rank-addressed injection: the rule triggers only in
  the process whose rank is ``k`` (in the port the
  ``torch.distributed`` rank, else 0), so ONE spec shared by every worker's
  environment can kill/corrupt/hang a *specific* rank:
  ``hop.exchange:corrupt%rank1@2`` poisons rank 1's second hop and
  nobody else's.  ``@nth`` counts that rank's own local hits.
* ``%mesh<k>`` — mesh-addressed injection (the rank selector's fleet
  sibling): the rule triggers only in a process whose fleet mesh id
  is ``k`` (``PENCILARRAYS_TPU_FLEET_MESH``, set by the mesh worker's
  launcher; a non-fleet process answers -1 and never matches), so ONE
  spec shared by every mesh's environment addresses a *whole mesh*:
  ``fleet.route:kill%mesh1@4`` SIGKILLs mesh 1 as it takes its 4th
  routed request — the whole-mesh loss drill.
* ``*times`` — trigger on that many consecutive hits (default: ``error``
  and ``corrupt`` forever, ``kill``/``torn`` once).
* ``@nth`` — first trigger on the *nth* hit of the point (1-based,
  default 1): ``io.write_block:torn@3`` tears the third block.

Sources, in precedence order: rules installed programmatically
(:func:`install` / the :func:`active` context manager), else the
``PENCILARRAYS_TPU_FAULTS`` environment variable (re-read whenever it
changes, so a worker can arm itself after import).  Example::

    PENCILARRAYS_TPU_FAULTS="io.write_block:torn@3,dist.initialize:error*3"
"""

from __future__ import annotations

import os
import re
import signal
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from .errors import InjectedFault

__all__ = [
    "POINTS",
    "Rule",
    "parse",
    "install",
    "clear",
    "reset_counters",
    "active",
    "armed",
    "fire",
    "hit_count",
    "block_write_hook",
    "kill_now",
    "delay_seconds",
    "ENV_VAR",
    "DELAY_S_VAR",
]

ENV_VAR = "PENCILARRAYS_TPU_FAULTS"

POINTS = frozenset({
    "io.open",
    "io.write_block",
    "io.flush_meta",
    "ckpt.commit",
    "ckpt.restore",
    "dist.initialize",
    "barrier",
    "hop.exchange",
    "serve.submit",
    "fleet.route",
    "kv.get",
    "kv.set",
})

MODES = frozenset({"error", "kill", "torn", "corrupt", "delay",
                   "drop", "partition"})

DELAY_S_VAR = "PENCILARRAYS_TPU_FAULTS_DELAY_S"
DEFAULT_DELAY_S = 0.25


def delay_seconds() -> float:
    """The injected-straggler sleep (``delay`` mode), env-tunable so a
    drill can scale the excess against its own hop durations."""
    try:
        return float(os.environ.get(DELAY_S_VAR, DEFAULT_DELAY_S))
    except ValueError:
        return DEFAULT_DELAY_S


@dataclass(frozen=True)
class Rule:
    point: str
    mode: str                  # one of MODES
    times: Optional[int]       # consecutive triggering hits (None = forever)
    first: int = 1             # 1-based hit index of the first trigger
    rank: Optional[int] = None   # %rank<k> selector (None = every rank)
    mesh: Optional[int] = None   # %mesh<k> selector (None = every mesh)

    def triggers(self, hit: int) -> bool:
        if hit < self.first:
            return False
        return self.times is None or hit < self.first + self.times


def parse(spec: str) -> List[Rule]:
    """Parse a spec string into rules (grammar in the module docstring)."""
    rules = []
    for raw in spec.replace(";", ",").split(","):
        raw = raw.strip()
        if not raw:
            continue
        try:
            point, rhs = raw.split(":", 1)
        except ValueError:
            raise ValueError(f"fault rule {raw!r}: expected point:mode")
        point = point.strip()
        if point not in POINTS:
            raise ValueError(
                f"unknown injection point {point!r}; registered points: "
                f"{sorted(POINTS)}")
        first = 1
        if "@" in rhs:
            rhs, nth = rhs.rsplit("@", 1)
            first = int(nth)
            if first < 1:
                raise ValueError(f"fault rule {raw!r}: @nth is 1-based")
        times: Optional[int]
        if "*" in rhs:
            mode, n = rhs.split("*", 1)
            times = int(n)
        else:
            mode, times = rhs, None
        rank: Optional[int] = None
        mesh: Optional[int] = None
        if "%" in mode:
            mode, sel = mode.split("%", 1)
            m = re.match(r"^(rank|mesh)(\d+)$", sel.strip())
            if not m:
                raise ValueError(
                    f"fault rule {raw!r}: selector {sel!r} is not "
                    f"'rank<k>' or 'mesh<k>' (e.g. "
                    f"hop.exchange:corrupt%rank1@2, "
                    f"fleet.route:kill%mesh1@4)")
            if m.group(1) == "rank":
                rank = int(m.group(2))
            else:
                mesh = int(m.group(2))
        mode = mode.strip()
        if mode not in MODES:
            raise ValueError(
                f"fault rule {raw!r}: mode {mode!r} not in {sorted(MODES)}")
        if times is None and mode in ("kill", "torn"):
            times = 1  # a crash repeats at most per-process anyway
        rules.append(Rule(point, mode, times, first, rank, mesh))
    return rules


# programmatic rules (highest precedence) + per-point hit counters
_rules: Optional[List[Rule]] = None
_env_cache: Optional[str] = None
_env_rules: List[Rule] = []
_hits: Dict[str, int] = {}


def install(spec) -> None:
    """Install rules programmatically (a spec string or ``Rule`` list);
    takes precedence over the environment until :func:`clear`."""
    global _rules
    _rules = parse(spec) if isinstance(spec, str) else list(spec)
    reset_counters()


def clear() -> None:
    """Drop programmatic rules (environment rules apply again)."""
    global _rules
    _rules = None
    reset_counters()


def reset_counters() -> None:
    _hits.clear()


def hit_count(point: str) -> int:
    """Hits recorded so far at ``point`` (the counter ``corrupt`` call
    sites use to address the deterministic poke)."""
    return _hits.get(point, 0)


@contextmanager
def active(spec):
    """Scope rules to a ``with`` block (the test-friendly entry point)."""
    global _rules
    prev = _rules
    install(spec)
    try:
        yield
    finally:
        _rules = prev
        reset_counters()


def _current_rules() -> Sequence[Rule]:
    if _rules is not None:
        return _rules
    global _env_cache, _env_rules
    env = os.environ.get(ENV_VAR, "")
    if env != _env_cache:          # re-read on change: workers arm late
        _env_cache = env
        _env_rules = parse(env) if env else []
    return _env_rules


def armed(point: str) -> bool:
    """Cheap probe: does any current rule target ``point``?  Hot paths
    use this to keep their no-faults fast path untouched (e.g. the
    binary writer's in-thread block copies).  Deliberately ignores the
    ``%rank``/``%mesh`` selectors (resolving identity is not
    probe-cheap): a rule addressed to another rank or mesh makes this
    process take the instrumented path, where :func:`fire` then
    correctly does nothing."""
    return any(r.point == point for r in _current_rules())


def _self_rank() -> int:
    """This process's rank for ``%rank<k>`` matching: ``cluster.rank``
    (the ``PENCILARRAYS_TPU_CLUSTER_RANK`` override, else the
    ``torch.distributed`` rank, else 0), the rule journal attribution
    uses too.  Resolved lazily: only rules that carry a rank selector pay
    for it."""
    from ..cluster import rank

    return rank()


def _self_mesh() -> int:
    """This process's fleet mesh id for ``%mesh<k>`` matching: -1, the
    JAX fleet layer's answer for a process that is no mesh worker (the
    port has no fleet layer yet), so a mesh selector never matches."""
    return -1


def kill_now() -> None:
    """SIGKILL this process — the un-catchable crash (no atexit, no
    flush): what a preempted worker actually looks like."""
    os.kill(os.getpid(), signal.SIGKILL)


def block_write_hook(i, start, block, block_observer, put, *,
                     flush=None, in_flight=(), **ctx) -> None:
    """The per-block injection + checksum hook every driver write path
    shares (ONE implementation of the torn semantics).  Fires
    ``io.write_block``; on a ``torn`` rule it orders any in-flight
    writes, writes a prefix of the block's leading-dim rows via ``put``,
    flushes, and SIGKILLs — the mid-checkpoint crash the resilience
    tests drill.  Otherwise it feeds the optional ``block_observer``
    (the checkpoint manager's checksum tap)."""
    act = fire("io.write_block", block=i, **ctx)
    if act == "torn":
        for fu in in_flight:  # order the tear after earlier blocks
            fu.result()
        put(start, block[: max(1, block.shape[0] // 2)])
        if flush is not None:
            flush()
        kill_now()
    if block_observer is not None:
        block_observer(start, block)


def _obs_firing(point: str, mode: str, hit: int, ctx: dict) -> None:
    """Journal a triggered rule BEFORE the fault takes effect (for
    ``kill``/``torn`` the fsync'd ``fault`` record is the only trace the
    dead process leaves), as the JAX package does."""
    from ..obs import enabled, record_event
    from ..obs.metrics import counter

    if not enabled():
        return
    counter("faults.fired", point=point, mode=mode).inc()
    record_event("fault", point=point, mode=mode, hit=hit, **{
        k: v for k, v in ctx.items() if k not in ("point", "mode", "hit")})


def fire(point: str, **ctx) -> Optional[str]:
    """Consult the injection point.  Returns ``None`` (the overwhelmingly
    common no-fault case), raises :class:`InjectedFault` (``error``),
    never returns (``kill``), or returns a cooperative mode string the
    call site honors: ``"torn"`` (write a partial block, then call
    :func:`kill_now`; sites that cannot tear treat it as ``kill``) or
    ``"corrupt"`` (the counter-addressed poke of the point's payload,
    ``guard.integrity.corrupt_array``)."""
    rules = _current_rules()
    if not rules:
        return None
    matching = [r for r in rules if r.point == point]
    if not matching:
        return None
    hit = _hits.get(point, 0) + 1
    _hits[point] = hit
    for r in matching:
        if not r.triggers(hit):
            continue
        if r.rank is not None and r.rank != _self_rank():
            continue   # addressed to another rank; counters still tick
        if r.mesh is not None and r.mesh != _self_mesh():
            continue   # addressed to another mesh; counters still tick
        _obs_firing(point, r.mode, hit, ctx)
        if r.mode == "delay":
            # the deterministic straggler: stall, then proceed — the
            # point's semantics (and any LATER rule on it) are untouched
            import time

            time.sleep(delay_seconds())
            continue
        if r.mode == "kill":
            kill_now()
        if r.mode in ("torn", "corrupt", "drop", "partition"):
            return r.mode
        where = f" [{ctx}]" if ctx else ""
        raise InjectedFault(
            f"injected fault at {point} (hit {hit}){where}",
            point=point, hit=hit)
    return None

