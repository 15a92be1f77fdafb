"""The comparisons that decide ``correct``: a relative error against the
reference's largest value, and a count of elements whose bits differ.
Both walk the leading dim in blocks, so that a pair of 4 GiB arrays
needs no full-size temporaries."""

from __future__ import annotations

import torch

BLOCK_ELEMS = 1 << 26


def _blocks(n0: int, row_elems: int):
    step = max(1, BLOCK_ELEMS // max(1, row_elems))
    for i in range(0, n0, step):
        yield slice(i, min(n0, i + step))


def max_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """``max|got - want| / max|want|`` in float64 (complex moduli);
    infinite where ``got`` holds a value that is not finite."""
    if got.shape != want.shape:
        raise ValueError(f"shapes differ: {tuple(got.shape)} against "
                         f"{tuple(want.shape)}")
    wide = torch.complex128 if want.is_complex() else torch.float64
    err = scale = 0.0
    for s in _blocks(got.shape[0], got[0].numel()):
        a, b = got[s].to(wide), want[s].to(wide)
        if not bool(torch.isfinite(a).all()):
            return float("inf")
        err = max(err, float((a - b).abs().max()))
        scale = max(scale, float(b.abs().max()))
    return err / scale if scale > 0 else float("inf")


def mismatched(got: torch.Tensor, want: torch.Tensor) -> int:
    """How many elements of ``got`` differ in their bits from ``want``
    (same shape and dtype; ``want`` may be any view)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return got.numel() if got.numel() else 1
    if got.is_complex():
        got, want = torch.view_as_real(got), torch.view_as_real(want)
    bits = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
            8: torch.int64}[got.element_size()]
    count = 0
    for s in _blocks(got.shape[0], got[0].numel()):
        a = got[s].contiguous().view(bits)
        b = want[s].contiguous().view(bits)
        count += int((a != b).sum())
    return count
