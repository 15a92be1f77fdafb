"""PencilFFT layer: device ms a step in cuFFT's kernels (``cufft``)."""

UNIT = "ms"


def read(w):
    s = w.group_s.get("cufft", 0.0)
    return 1e3 * s / w.steps if s > 0 else None
