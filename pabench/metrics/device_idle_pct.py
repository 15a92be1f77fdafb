"""Device: the share of the window in which no operation ran on the card
(one minus the union of the device operations' intervals)."""

UNIT = "%"


def read(w):
    if w.busy_s <= 0:
        return None
    return 100.0 * (1.0 - w.busy_s / w.span_s)
