"""Finite-difference stencils on pencils, with an explicit halo exchange.

PyTorch counterpart of the JAX package's ``ops/stencil.py``.  There the
halo exchange is GSPMD's partition of a ``jnp.roll`` of the global array;
here it is explicit.  :func:`shift` along a decomposed dim sends each rank
exactly the rows it needs from the ranks that own them, with one batch of
point-to-point calls on the topology axis's sub-group (the pattern of
``parallel/transpositions.py`` ``ring_shift``).  Usually those rows are a
boundary layer ``|k|`` deep from a ring neighbour; under the ceil rule a
block can be thinner than ``|k|`` or empty (n = 5 over 4 ranks gives 2,
2, 1, 0 rows), so a row may come from a rank further along the ring, and
the periodic seam skips the tail padding.  A shift never sends a whole
block unless the block is the rows needed.  Along a dim that is not
decomposed (or on a size-1 axis) the shift is local: two copies, as
``torch.roll`` would make.  Either way the result has the input's pencil,
its bits are the JAX package's, and its tail padding is zero.

:data:`halo_exchange` counts what this rank sends (batches, messages,
bytes): the counterpart of the JAX package's HLO budget
(``tests/test_stencil.py`` ``test_halo_hlo_budget``,
``test_padded_dim_halo_bytes``).

On top of :func:`shift`: the second-order centred difference operators,
boundary-aware and differentiable (the gradient of a shift by ``k`` is
the shift by ``-k``).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

from ..parallel.arrays import PencilArray
from ..parallel import collectives as _collectives
from ..parallel.pencil import Pencil

__all__ = ["shift", "diff", "fd_gradient", "fd_divergence", "fd_laplacian",
           "halo_exchange"]

_BOUNDARIES = ("periodic", "zero")

# what this rank sent: batch_isend_irecv calls, messages, bytes
halo_exchange = {"calls": 0, "messages": 0, "bytes": 0}


def _mem_axis(pencil: Pencil, axis: int) -> int:
    perm = pencil.permutation
    if perm.is_identity():
        return axis
    return perm.axes().index(axis)


def _pieces(p: int, b: int, n: int, k: int, boundary: str
            ) -> List[Tuple[int, int, int, int]]:
    """Where block ``p``'s shifted rows come from, as ``(j, q, s, m)``:
    local rows ``j:j+m`` of the result are rows ``s:s+m`` of block ``q``
    (blocks of ``b`` padded rows; ``n`` true rows in all).  Every rank
    computes every block's list, so senders and receivers agree."""
    lo, hi = min(p * b, n), min((p + 1) * b, n)
    runs = []
    if boundary == "periodic":
        g = lo
        while g < hi:
            s = (g + k) % n
            m = min(hi - g, n - s)        # up to where the source wraps
            runs.append((g, s, m))
            g += m
    else:
        g0, g1 = max(lo, -k), min(hi, n - k)
        if g0 < g1:
            runs.append((g0, g0 + k, g1 - g0))
    out = []
    for g, s, m in runs:                  # split at the owners' edges
        while m:
            q = s // b
            c = min(m, (q + 1) * b - s)
            out.append((g - p * b, q, s - q * b, c))
            g, s, m = g + c, s + c, m - c
    return out


def _shift_data(data: torch.Tensor, pen: Pencil, axis: int, k: int,
                boundary: str) -> torch.Tensor:
    """The shifted memory-order block (see :func:`shift`)."""
    ax = _mem_axis(pen, axis)
    n = pen.size_global()[axis]
    topo = pen.topology
    try:
        i = pen.decomposition.index(axis)
    except ValueError:
        P, me = 1, 0
    else:
        P = topo.dims[i]
        me = topo.coords_local[i] if P > 1 else 0
    b = data.shape[ax]
    out = torch.empty_like(data)
    mine = _pieces(me, b, n, k, boundary) if n else []
    covered = [0] * b
    for j, _, _, m in mine:
        covered[j:j + m] = [1] * m
    j = 0
    while j < b:                          # rows no piece writes are zero
        if covered[j]:
            j += 1
            continue
        e = j
        while e < b and not covered[e]:
            e += 1
        out.narrow(ax, j, e - j).zero_()
        j = e
    for j, q, s, m in mine:
        if q == me:
            out.narrow(ax, j, m).copy_(data.narrow(ax, s, m))
    if P == 1:
        return out
    coords = list(topo.coords_local)

    def peer(c):
        coords[i] = c
        return topo.global_rank(topo.rank(coords))

    group = topo.subcomm(i)
    ops, recvs = [], []
    for p in range(P):                    # rows other blocks need from me
        if p == me:
            continue
        rows = [data.narrow(ax, s, m) for _, q, s, m
                in _pieces(p, b, n, k, boundary) if q == me]
        if rows:
            buf = torch.cat(rows, dim=ax).contiguous()
            ops.append(dist.P2POp(dist.isend, buf, peer(p), group))
            halo_exchange["messages"] += 1
            halo_exchange["bytes"] += buf.numel() * buf.element_size()
            _collectives.note("collective-permute",
                              buf.numel() * buf.element_size(),
                              shape=buf.shape, dtype=buf.dtype,
                              async_start=True,
                              pair=(topo.global_rank(topo.rank_local),
                                    peer(p)))
    for q in range(P):                    # rows I need from other blocks
        want = [(j, m) for j, qq, _, m in mine if qq == q and q != me]
        if want:
            shape = list(data.shape)
            shape[ax] = sum(m for _, m in want)
            buf = data.new_empty(shape)
            ops.append(dist.P2POp(dist.irecv, buf, peer(q), group))
            recvs.append((buf, want))
    if ops:
        halo_exchange["calls"] += 1
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    for buf, want in recvs:
        at = 0
        for j, m in want:
            out.narrow(ax, j, m).copy_(buf.narrow(ax, at, m))
            at += m
    return out


class _Shift(torch.autograd.Function):
    """The shift's gradient is the shift by ``-k`` (same boundary)."""

    @staticmethod
    def forward(ctx, data, pen, axis, k, boundary):
        ctx.args = (pen, axis, k, boundary)
        return _shift_data(data, pen, axis, k, boundary)

    @staticmethod
    def backward(ctx, grad):
        pen, axis, k, boundary = ctx.args
        return (_shift_data(grad.contiguous(), pen, axis, -k, boundary),
                None, None, None, None)


def shift(u: PencilArray, axis: int, offset: int, *,
          boundary: str = "periodic") -> PencilArray:
    """``shift(u, axis, k)[..., i, ...] == u[..., i+k, ...]`` along a
    logical spatial ``axis``: data moves *toward lower indices* for
    positive ``k`` (the upwind neighbour view).

    ``boundary``: ``"periodic"`` wraps indices mod the true extent;
    ``"zero"`` reads out-of-range positions as 0.  Works along any dim —
    local, decomposed, padded, permuted.  Along a decomposed dim every
    rank of the axis's sub-group must call it (it exchanges rows)."""
    if boundary not in _BOUNDARIES:
        raise ValueError(f"boundary must be one of {_BOUNDARIES}")
    pen = u.pencil
    if not 0 <= axis < pen.ndims:
        raise ValueError(f"axis {axis} out of range for {pen.ndims}-dim pencil")
    k = int(offset)
    if u.data.requires_grad and torch.is_grad_enabled():
        out = _Shift.apply(u.data, pen, axis, k, boundary)
    else:
        out = _shift_data(u.data, pen, axis, k, boundary)
    return PencilArray(pen, out, u.extra_dims)


def diff(u: PencilArray, axis: int, *, order: int = 1,
         spacing: float = 1.0, boundary: str = "periodic") -> PencilArray:
    """Second-order centred finite difference along a logical axis.

    ``order=1``: ``(u[i+1] - u[i-1]) / (2 h)``;
    ``order=2``: ``(u[i+1] - 2 u[i] + u[i-1]) / h^2``.
    """
    if order not in (1, 2):
        raise ValueError("order must be 1 or 2 (centered stencils)")
    up = shift(u, axis, +1, boundary=boundary)
    dn = shift(u, axis, -1, boundary=boundary)
    if order == 1:
        return (up - dn) * (0.5 / spacing)
    return (up - u * 2.0 + dn) * (1.0 / spacing ** 2)


def _spacings(pen: Pencil, spacing) -> Tuple[float, ...]:
    if isinstance(spacing, (int, float)):
        return (float(spacing),) * pen.ndims
    out = tuple(float(s) for s in spacing)
    if len(out) != pen.ndims:
        raise ValueError("need one spacing per spatial dim")
    return out


def fd_gradient(u: PencilArray, *, spacing=1.0,
                boundary: str = "periodic") -> Tuple[PencilArray, ...]:
    """Centred-difference gradient: one PencilArray per spatial dim (the
    FD analog of ``ops.spectral_ops.gradient``)."""
    hs = _spacings(u.pencil, spacing)
    return tuple(diff(u, d, order=1, spacing=hs[d], boundary=boundary)
                 for d in range(u.pencil.ndims))


def fd_divergence(fields: Sequence[PencilArray], *, spacing=1.0,
                  boundary: str = "periodic") -> PencilArray:
    """Divergence of a vector field given as one PencilArray per dim."""
    fields = tuple(fields)
    pen = fields[0].pencil
    if len(fields) != pen.ndims:
        raise ValueError("need one field component per spatial dim")
    hs = _spacings(pen, spacing)
    out = diff(fields[0], 0, order=1, spacing=hs[0], boundary=boundary)
    for d in range(1, pen.ndims):
        out = out + diff(fields[d], d, order=1, spacing=hs[d],
                         boundary=boundary)
    return out


def fd_laplacian(u: PencilArray, *, spacing=1.0,
                 boundary: str = "periodic") -> PencilArray:
    """Centred-difference Laplacian (sum of second differences)."""
    hs = _spacings(u.pencil, spacing)
    out = diff(u, 0, order=2, spacing=hs[0], boundary=boundary)
    for d in range(1, u.pencil.ndims):
        out = out + diff(u, d, order=2, spacing=hs[d], boundary=boundary)
    return out
