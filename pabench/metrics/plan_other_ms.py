"""PencilFFT layer: device ms a step of the plan's own operations that
are neither cuFFT's nor K1's (innermost span ``plan.forward``,
``plan.backward`` or ``stage_compute``; kernel group neither ``cufft``
nor ``k1_permute``): the copies and scalar passes around the
transforms."""

from .. import span_reduce as sr

UNIT = "ms"
SPANS = ("plan.forward", "plan.backward", "stage_compute")
OWN = ("cufft", "k1_permute")


def read(w):
    att = sr.of(w)
    if att is None or not any(att.count.get(s) for s in SPANS):
        return None
    s = sum(v for (span, group), v in att.group_seconds.items()
            if span in SPANS and group not in OWN)
    return 1e3 * s / w.steps
