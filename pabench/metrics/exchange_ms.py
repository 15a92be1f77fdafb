"""Exchange layer: device ms a step in NCCL kernels and device copies
(``exchange``; on one rank an all-to-all is a device copy), in a window
where the program made exchange calls: elsewhere a device copy is some
other layer's."""

UNIT = "ms"


def read(w):
    calls = sum(n for k, n in w.counters.items()
                if k.startswith("exchange_calls."))
    s = w.group_s.get("exchange", 0.0)
    return 1e3 * s / w.steps if s > 0 and calls > 0 else None
