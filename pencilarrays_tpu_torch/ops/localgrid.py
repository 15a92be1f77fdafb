"""Rectilinear grids aligned with a pencil decomposition.

PyTorch counterpart of the part of the JAX package's ``ops/localgrid.py``
the Taylor–Green initial condition needs (reference ``src/LocalGrids/``):
per-dimension coordinate vectors of this rank's block, zero-padded to the
padded extent and shaped to broadcast against ``PencilArray.data`` in
memory order.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..parallel.arrays import numpy_to_torch
from ..parallel.pencil import LogicalOrder, Pencil

__all__ = ["LocalRectilinearGrid", "localgrid"]


class LocalRectilinearGrid:
    """Per-dimension coordinate vectors over a pencil (reference
    ``LocalRectilinearGrid``, ``rectilinear.jl:8-15``)."""

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

    def components(self) -> Tuple[torch.Tensor, ...]:
        return tuple(self[d] for d in range(self._pencil.ndims))


def localgrid(pencil: Pencil, coords_global: Sequence) -> LocalRectilinearGrid:
    """Grid over a pencil from global coordinate vectors (reference
    ``localgrid``, ``Pencils.jl:600-605``)."""
    return LocalRectilinearGrid(pencil, coords_global)
