"""Transpose layer: the whole step's share of the bandwidth roofline of
its hops, each of which must read and write the array once (bytes from
shapes, whatever implements the hop), against the traced window's time a
step."""

UNIT = "%"


def read(w):
    if not w.transpose_bytes:
        return None
    least_s = w.transpose_bytes / w.peaks["hbm_bytes_per_s"]
    return 100.0 * least_s / (w.seconds / w.steps)
