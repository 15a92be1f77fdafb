"""Device time per iteration for benchmarks (the JAX package's
``utils/benchtime.py`` protocol, on CUDA events).

1. run K iterations of the body back to back between two CUDA events on
   the current stream (on the CPU: between two ``perf_counter`` reads);
2. take the minimum over several repeats per K arm;
3. difference two K values to cancel the fixed cost of a run;
4. guard the slope: a non-positive or implausibly small slope (noise
   swamping the difference) falls back to the conservative upper bound
   ``t(k1)/k1``.

The per-repeat spread rides along (:func:`last_spread`), so a number is
kept with its noise floor.  On the card the events time the device: the
host may run ahead of the work it launched, and the end event is waited
for before it is read.
"""

from __future__ import annotations

import time
from typing import Callable

__all__ = ["device_seconds_per_iter", "last_spread"]

_LAST_SPREAD: dict = {"k1_worst_over_best": None, "slope_fallback": None}


def last_spread() -> dict:
    """Spread of the most recent measurement: the k1 arm's worst/best
    ratio over its repeats (1.0 = perfectly stable) and
    ``slope_fallback``, whether the slope guard reported ``t(k1)/k1``
    instead of the K-differenced slope.  With observability on it also
    lands in the metrics snapshot (``obs.snapshot()["benchtime"]``)."""
    return dict(_LAST_SPREAD)


def _on_cuda(x) -> bool:
    import torch

    leaves = x if isinstance(x, (tuple, list)) else (x,)
    return any(isinstance(t, torch.Tensor) and t.is_cuda for t in leaves)


def device_seconds_per_iter(body: Callable, x0, *, k0: int, k1: int,
                            repeats: int = 5) -> float:
    """Seconds per iteration of ``body`` (a data -> data function of
    tensors), K iterations chained from ``x0``."""
    import torch

    if not 1 <= k0 < k1:
        raise ValueError(f"need 1 <= k0 < k1, got k0={k0}, k1={k1}")
    cuda = _on_cuda(x0)

    def run(K):
        d = x0
        for _ in range(K):
            d = body(d)
        return d

    def timed(K):
        run(K)                      # warm: plans, caches, the first launch
        best, worst = float("inf"), 0.0
        for _ in range(repeats):
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                run(K)
                end.record()
                end.synchronize()
                dt = start.elapsed_time(end) / 1e3
            else:
                t0 = time.perf_counter()
                run(K)
                dt = time.perf_counter() - t0
            best = min(best, dt)
            worst = max(worst, dt)
        return best, worst

    t_k0, _ = timed(k0)
    t_k1, w_k1 = timed(k1)
    spread = round(w_k1 / t_k1, 3) if t_k1 else None
    _LAST_SPREAD["k1_worst_over_best"] = spread
    slope = (t_k1 - t_k0) / (k1 - k0)
    upper = t_k1 / k1   # includes the amortized fixed cost: >= the slope
    fallback = slope <= 0 or slope < 1e-3 * upper
    _LAST_SPREAD["slope_fallback"] = fallback
    if fallback:
        slope = upper
    from ..obs import enabled as _obs_enabled

    if _obs_enabled():
        from ..obs import counter, gauge

        counter("benchtime.measurements").inc()
        if fallback:
            counter("benchtime.slope_fallbacks").inc()
        if spread is not None:
            gauge("benchtime.last_spread").set(spread)
    return slope
