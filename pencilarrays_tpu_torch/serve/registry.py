"""Plan registry — one resident executable per plan fingerprint (the JAX
package's ``serve/registry.py`` over the port's
:class:`~pencilarrays_tpu_torch.ops.fft.CompiledPlan`).

The service's tenants describe *what* they want transformed; the
registry makes sure equivalent descriptions share ONE compiled
executable.  Keys are :meth:`~pencilarrays_tpu_torch.ops.fft.PencilFFTPlan.
plan_key` fingerprints — deterministic across processes and
restarts (the same digest family the obs journal stamps as ``plan_fp``
and the crash bundle records as ``schedule_sha256``), so two tenants
that each built their own ``PencilFFTPlan`` over the same
``(global_shape, dtype, topology, schedule)`` configuration resolve to
the same registry entry and the same ``CompiledPlan``.

Cache accounting rides the existing ``compile.cache_hits|misses``
counters with a ``cache="serve"`` label and a per-tenant dimension.
A registry hit short-circuits :meth:`PencilFFTPlan.compile` entirely,
and the miss path calls it with its own plan-level counter suppressed
(``_counters=False``) — one resolve, one count, never the
double-count a naive delegation would produce (plan-level ``cache=
"plan"`` counters keep counting direct ``plan.compile()`` callers
only).

Rebind semantics (the elastic-reformation contract): ``register(plan)``
dedups on the fingerprint — first registration wins and callers use the
returned *canonical* plan — while ``register(plan, replace=True)``
swaps the stored plan object AND drops every compiled executable under
that key: a rebuilt plan has the same fingerprint (same static
configuration) but lives on a NEW mesh, and a cached executable from
the dead mesh must never be dispatched again.

On the card each executable holds one CUDA graph per direction, and each
distinct coalesced batch size is an executable of its own.  All the
executables of one plan capture into ONE graph memory pool (the plan's,
see :class:`~pencilarrays_tpu_torch.ops.fft.CompiledPlan`, which
serializes the replays of one pool), so B = 1..8 in both directions hold
one pool, not sixteen.  Dropping an executable frees its graphs, and the
pool goes with the plan's last graph.  :meth:`PlanRegistry.graph_info`
reads each variant's pool bytes.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence, Tuple

__all__ = ["PlanRegistry"]


class PlanRegistry:
    """Fingerprint-keyed store of plans and their compiled executables."""

    def __init__(self):
        self._lock = threading.Lock()
        # key -> plan (the canonical object for that fingerprint)
        self._plans: Dict[str, object] = {}
        # (key, extra_dims, donate) -> CompiledPlan
        self._compiled: Dict[tuple, object] = {}
        self._hits = 0
        self._misses = 0

    # -- plans -------------------------------------------------------------
    def register(self, plan, *, replace: bool = False):
        """Register ``plan`` under its :meth:`plan_key` and return the
        canonical plan for that key (the first-registered object, unless
        ``replace=True`` swaps it and invalidates the key's compiled
        executables — the elastic rebuild path)."""
        key = plan.plan_key()
        with self._lock:
            cur = self._plans.get(key)
            if cur is not None and not replace:
                return cur
            stale = ([] if cur is None or cur is plan
                     else self._drop_compiled_locked(key))
            self._plans[key] = plan
        for cp in stale:
            cp.release()
        return plan

    def plan(self, key: str):
        """The canonical plan registered under ``key`` (None if absent)."""
        return self._plans.get(key)

    def keys(self) -> Tuple[str, ...]:
        return tuple(self._plans)

    def _drop_compiled_locked(self, key: Optional[str]) -> list:
        stale = [k for k in self._compiled if key is None or k[0] == key]
        return [self._compiled.pop(k) for k in stale]

    def drop_executables(self, key: Optional[str] = None) -> int:
        """Drop compiled executables (all of them, or one key's) and free
        their CUDA graphs (:meth:`~pencilarrays_tpu_torch.ops.fft.
        CompiledPlan.release`) — refilled on demand.  Returns how many
        were discarded."""
        with self._lock:
            stale = self._drop_compiled_locked(key)
        for cp in stale:
            cp.release()
        return len(stale)

    # -- executables -------------------------------------------------------
    def compiled(self, plan, extra_dims: Tuple[int, ...] = (), *,
                 donate: bool = False,
                 tenants: Sequence[str] = ()) -> object:
        """Resolve the ``CompiledPlan`` for ``(plan_key, extra_dims,
        donate)``, compiling on first use.  ``tenants`` attributes the
        hit/miss counters: one ``compile.cache_{hits|misses}{cache=
        "serve", tenant=...}`` bump per requesting tenant (a coalesced
        batch spans tenants; each of them experienced the hit)."""
        key = plan.plan_key()
        sub = (key, tuple(int(e) for e in extra_dims), bool(donate))
        with self._lock:
            self._plans.setdefault(key, plan)
            cp = self._compiled.get(sub)
        hit = cp is not None
        if not hit:
            # resolve OUTSIDE the registry lock (another tenant's cache
            # hit must not queue behind it) and with the plan-level
            # counter suppressed: THIS resolve is the one cache event.
            # A racing miss resolves twice (plan.compile's own per-plan
            # cache dedups the executable) and the first insert wins.
            new = plan.compile(sub[1], donate=donate, _counters=False)
            with self._lock:
                cp = self._compiled.setdefault(sub, new)
        with self._lock:
            self._hits += hit
            self._misses += not hit
        from .. import obs

        if obs.enabled():
            name = f"compile.cache_{'hits' if hit else 'misses'}"
            for t in (tenants or ("-",)):
                obs.counter(name, cache="serve", tenant=str(t)).inc()
        return cp

    def executables(self, key: Optional[str] = None) -> Tuple[object, ...]:
        """The resident :class:`~pencilarrays_tpu_torch.ops.fft.CompiledPlan`
        executables (one key's, or all) — what a pre-flight
        certification sweep (``PlanService.certify()``) walks."""
        with self._lock:
            return tuple(cp for k, cp in self._compiled.items()
                         if key is None or k[0] == key)

    def graph_info(self, key: Optional[str] = None) -> Dict[tuple, dict]:
        """Each resident executable's captured graphs, ``{(plan_key,
        extra_dims, donate): {direction: {"k1_launches",
        "pool_total_bytes"}}}``: :meth:`~pencilarrays_tpu_torch.ops.fft.
        CompiledPlan.graph_info` and the bytes of the device segments its
        plan's graph pool holds now, as the caching allocator's snapshot
        lists them, read once a call (directions not captured yet, and
        every executable on the CPU, are absent)."""
        import torch

        with self._lock:
            items = [(k, cp) for k, cp in self._compiled.items()
                     if key is None or k[0] == key]
        out, segments = {}, None
        for k, cp in items:
            info = {d: cp.graph_info(d) for d in ("forward", "backward")}
            info = {d: i for d, i in info.items() if i is not None}
            if not info:
                continue
            if segments is None:
                segments = torch.cuda.memory._snapshot()["segments"]
            dev = cp.plan.topology.device
            index = (dev.index if dev.index is not None
                     else torch.cuda.current_device())
            pool = tuple(cp.pool_handle or ())
            total = sum(s["total_size"] for s in segments
                        if s.get("device") == index
                        and tuple(s.get("segment_pool_id") or ()) == pool)
            out[k] = {d: dict(i, pool_total_bytes=total)
                      for d, i in info.items()}
        return out

    def stats(self) -> dict:
        with self._lock:
            return {"plans": len(self._plans),
                    "executables": len(self._compiled),
                    "hits": self._hits, "misses": self._misses}
