"""Index iterators that walk in memory order while presenting logical
indices (a copy of the JAX package's ``utils/permuted_indices.py``; it is
NumPy only).

Reference ``src/PermutedIndices/PermutedIndices.jl``: default Cartesian
iteration over a permuted array walks out of memory order — a perf trap
the reference fixes with ``PermutedLinearIndices`` (``:17-49``) and
``PermutedCartesianIndices`` (``:51-93``), converting logical -> memory
via ``perm * I`` and memory -> logical via ``perm \\ I``.

In the port, per-element host loops are never the compute path
(broadcasting and torch ops are), so these utilities exist for
*host-side* tasks that genuinely enumerate indices — test assertions, debug dumps, building
scatter maps for I/O — with the same memory-order-walk guarantee.
"""

from __future__ import annotations

import math
from typing import Iterator, Sequence, Tuple

import numpy as np

from .permutations import AbstractPermutation

__all__ = ["PermutedLinearIndices", "PermutedCartesianIndices"]


class PermutedCartesianIndices:
    """Iterate logical index tuples in *memory* order
    (reference ``PermutedCartesianIndices``, ``PermutedIndices.jl:51-93``).

    ``shape`` is the logical shape; iteration visits elements so that the
    underlying memory-order array is walked contiguously (last memory dim
    fastest), yielding each position's *logical* index tuple.
    """

    def __init__(self, shape: Sequence[int], perm: AbstractPermutation):
        self.shape = tuple(int(n) for n in shape)
        self.perm = perm
        self.shape_mem = perm.apply(self.shape)

    def __len__(self) -> int:
        return math.prod(self.shape)

    def __iter__(self) -> Iterator[Tuple[int, ...]]:
        for mem_idx in np.ndindex(*self.shape_mem):
            # memory -> logical: perm \ I  (PermutedIndices.jl:72)
            yield self.perm.invapply(tuple(int(i) for i in mem_idx))

    def __getitem__(self, linear: int) -> Tuple[int, ...]:
        """Logical index of the ``linear``-th element in memory order."""
        mem_idx = np.unravel_index(linear, self.shape_mem)
        return self.perm.invapply(tuple(int(i) for i in mem_idx))


class PermutedLinearIndices:
    """Memory-order linear index of logical positions
    (reference ``PermutedLinearIndices``, ``PermutedIndices.jl:17-49``)."""

    def __init__(self, shape: Sequence[int], perm: AbstractPermutation):
        self.shape = tuple(int(n) for n in shape)
        self.perm = perm
        self.shape_mem = perm.apply(self.shape)

    def __len__(self) -> int:
        return math.prod(self.shape)

    def __iter__(self) -> Iterator[int]:
        return iter(range(len(self)))

    def __getitem__(self, logical_idx: Sequence[int]) -> int:
        """Linear (memory-order) position of a logical index tuple:
        logical -> memory via ``perm * I`` (PermutedIndices.jl:46)."""
        mem_idx = self.perm.apply(tuple(logical_idx))
        return int(np.ravel_multi_index(mem_idx, self.shape_mem))
