"""Model layer: device ms a step in PyTorch's elementwise, reduction and
stack kernels (the ``elementwise`` and ``stack_cat`` groups)."""

UNIT = "ms"


def read(w):
    s = w.group_s.get("elementwise", 0.0) + w.group_s.get("stack_cat", 0.0)
    return 1e3 * s / w.steps if s > 0 else None
