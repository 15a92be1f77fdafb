"""Model layer: device operations a step launched by the model itself,
outside the plan (innermost span ``ns.step`` or ``ns.nonlinear``): the
launches that a fusion of its elementwise passes would cut."""

from .. import span_reduce as sr
from .model_self_ms import SPANS

UNIT = "ops"


def read(w):
    att = sr.of(w)
    if att is None:
        return None
    n = sum(att.count.get(s, 0) for s in SPANS)
    return n / w.steps if n > 0 else None
