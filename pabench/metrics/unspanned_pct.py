"""Device: the share of the window's device-operation time whose launch
no program span encloses (the time no per-span metric can name)."""

from .. import span_reduce as sr

UNIT = "%"


def read(w):
    att = sr.of(w)
    if att is None or att.total_s <= 0:
        return None
    return 100.0 * att.seconds.get(sr.UNSPANNED, 0.0) / att.total_s
