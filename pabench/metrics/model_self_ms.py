"""Model layer: device ms a step of the operations launched by the model
itself, outside the plan (innermost span ``ns.step`` or
``ns.nonlinear``)."""

from .. import span_reduce as sr

UNIT = "ms"
SPANS = ("ns.step", "ns.nonlinear")


def read(w):
    att = sr.of(w)
    if att is None:
        return None
    return sr.per_step_ms(w, sum(att.seconds.get(s, 0.0) for s in SPANS))
