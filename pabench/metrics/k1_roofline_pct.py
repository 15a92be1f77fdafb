"""K1 (the permute kernel): its share of the bandwidth roofline, the
bytes it read and wrote by the program's counter over the least time the
card's memory needs for them, against K1's device time (``k1_permute``)."""

UNIT = "%"


def read(w):
    s = w.group_s.get("k1_permute", 0.0)
    nbytes = w.counters.get("k1_bytes", 0)
    if s <= 0 or nbytes <= 0:
        return None
    return 100.0 * (nbytes / w.peaks["hbm_bytes_per_s"]) / s
