"""Transpose layer: the hops' share of their bandwidth roofline, each hop
reading and writing the array once (bytes from shapes, as
``transpose_roofline_pct``), against the device time a step of the
operations launched inside ``transpose!`` and the spans under it."""

from .. import span_reduce as sr

UNIT = "%"


def read(w):
    att = sr.of(w)
    if att is None or not w.transpose_bytes:
        return None
    s = att.under_seconds.get("transpose!", 0.0)
    if s <= 0:
        return None
    least_s = w.transpose_bytes / w.peaks["hbm_bytes_per_s"]
    return 100.0 * least_s / (s / w.steps)
