"""Rectilinear grids aligned with a pencil decomposition.

PyTorch counterpart of the JAX package's ``ops/localgrid.py`` (reference
``src/LocalGrids/`` and the ``localgrid`` hook, ``Pencils.jl:600-605``):
per-dimension coordinate vectors of this rank's block, zero-padded to the
padded extent and shaped to broadcast against ``PencilArray.data`` in
memory order (``rectilinear.jl:132-139``), so ``evaluate(f)`` computes
``f(x, y, z)`` over the block with no communication.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence, Tuple

import torch

from ..parallel.arrays import PencilArray, numpy_to_torch
from ..parallel.pencil import LogicalOrder, MemoryOrder, Pencil

__all__ = ["LocalRectilinearGrid", "localgrid"]

_COMPONENT_NAMES = "xyzw"


class LocalRectilinearGrid:
    """Per-dimension coordinate vectors over a pencil (reference
    ``LocalRectilinearGrid``, ``rectilinear.jl:8-15``).

    ``g[i]`` and ``g.x``/``g.y``/``g.z``/``g.w`` are COMPONENTS (this
    rank's coordinates along one dim, broadcast-ready); ``len(g)`` and
    iteration range over the global GRID POINTS, as in the reference.
    """

    def __init__(self, pencil: Pencil, coords_global: Sequence):
        if len(coords_global) != pencil.ndims:
            raise ValueError(f"need {pencil.ndims} coordinate vectors, got "
                             f"{len(coords_global)}")
        self._pencil = pencil
        self._coords = []
        for d, c in enumerate(coords_global):
            c = numpy_to_torch(c)
            if c.dim() != 1 or c.shape[0] != pencil.size_global()[d]:
                raise ValueError(
                    f"coordinate vector {d} must be 1-D of length "
                    f"{pencil.size_global()[d]}, got shape {tuple(c.shape)}")
            self._coords.append(c)

    @property
    def pencil(self) -> Pencil:
        return self._pencil

    @property
    def ndims(self) -> int:
        return self._pencil.ndims

    def coordinate(self, d: int) -> torch.Tensor:
        """The global, true-length coordinate vector of dim ``d``."""
        return self._coords[d]

    def __getitem__(self, d: int) -> torch.Tensor:
        """This rank's component for logical dim ``d``: its slice of the
        coordinates, zero-padded, non-singleton at ``d``'s memory
        position (the analog of ``rectilinear.jl:132-139``)."""
        pen = self._pencil
        N = pen.ndims
        if not 0 <= d < N:
            raise IndexError(f"component {d} out of range for {N} dims")
        r = pen.range_local()[d]
        n_pad = pen.padded_size_local(LogicalOrder)[d]
        c = torch.zeros(n_pad, dtype=self._coords[d].dtype)
        c[:len(r)] = self._coords[d][r.start:r.stop]
        shape = [1] * N
        shape[pen.permutation.apply(tuple(range(N))).index(d)] = n_pad
        return c.reshape(shape).to(pen.topology.device)

    def __getattr__(self, name: str):
        if len(name) == 1 and name in _COMPONENT_NAMES:
            d = _COMPONENT_NAMES.index(name)
            if d < self.ndims:
                return self[d]
        raise AttributeError(name)

    def components(self) -> Tuple[torch.Tensor, ...]:
        return tuple(self[d] for d in range(self._pencil.ndims))

    def _wrap(self, val: torch.Tensor, extra_dims: Tuple[int, ...]
              ) -> PencilArray:
        """Broadcast a memory-order value to the padded block and wrap it
        (the shared tail of :meth:`evaluate` and :meth:`zip_with`)."""
        target = self._pencil.padded_size_local(MemoryOrder) + tuple(
            extra_dims)
        return PencilArray(self._pencil,
                           torch.broadcast_to(val, target).contiguous(),
                           tuple(extra_dims))

    def evaluate(self, f: Callable, extra_dims: Tuple[int, ...] = ()
                 ) -> PencilArray:
        """``u = f(x, y, z, ...)`` over the grid, as a PencilArray (the
        grid broadcast of ``README.md:101`` / ``benchmarks/grids.jl``)."""
        val = f(*self.components())
        if extra_dims:
            val = val.reshape(tuple(val.shape) + (1,) * len(extra_dims))
        return self._wrap(val, extra_dims)

    def zip_with(self, f: Callable, *arrays: PencilArray) -> PencilArray:
        """``v = f(u1, ..., x, y, z)`` elementwise over array values and
        grid coordinates (the ``zip(eachindex(u), grid)`` style of
        ``benchmarks/grids.jl:117``).  Arrays must live on this grid's
        pencil and share extra dims; the coordinates broadcast over
        them."""
        pen = self._pencil
        for a in arrays:
            if a.pencil != pen:
                raise ValueError(
                    "zip_with: array pencil differs from grid pencil")
        extra = arrays[0].extra_dims if arrays else ()
        for a in arrays[1:]:
            if a.extra_dims != extra:
                raise ValueError("zip_with: extra_dims mismatch")
        comps = self.components()
        if extra:
            comps = tuple(c.reshape(tuple(c.shape) + (1,) * len(extra))
                          for c in comps)
        return self._wrap(f(*(a.data for a in arrays), *comps), extra)

    def __len__(self) -> int:
        return math.prod(self._pencil.size_global())

    def __iter__(self):
        """Host-side walk over the GLOBAL grid points in memory order,
        yielding logical-order coordinate tuples (``rectilinear.jl:110-130``;
        for tests and debugging, not for compute)."""
        from ..utils.permuted_indices import PermutedCartesianIndices

        coords = [c.numpy() for c in self._coords]
        for idx in PermutedCartesianIndices(self._pencil.size_global(),
                                            self._pencil.permutation):
            yield tuple(coords[d][i] for d, i in enumerate(idx))

    def __reversed__(self):
        return reversed(list(self))

    def meshgrid(self) -> Tuple[torch.Tensor, ...]:
        """Dense coordinate fields of this rank's padded memory-order block,
        one per dim (``meshgrid`` for code that wants them explicit)."""
        target = self._pencil.padded_size_local(MemoryOrder)
        return tuple(torch.broadcast_to(self[d], target).contiguous()
                     for d in range(self.ndims))

    def __repr__(self) -> str:
        return (f"LocalRectilinearGrid(ndims={self.ndims}, "
                f"pencil={self._pencil!r})")


def localgrid(pencil: Pencil, coords_global: Sequence) -> LocalRectilinearGrid:
    """Grid over a pencil from global coordinate vectors (reference
    ``localgrid``, ``Pencils.jl:600-605``)."""
    return LocalRectilinearGrid(pencil, coords_global)
