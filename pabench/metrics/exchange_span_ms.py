"""Exchange layer: device ms a step of the operations launched inside the
``exchange`` span (the exchange call and its wait), whatever kernel or
copy carries them."""

from .. import span_reduce as sr

UNIT = "ms"


def read(w):
    att = sr.of(w)
    if att is None:
        return None
    return sr.per_step_ms(w, att.seconds.get("exchange", 0.0))
