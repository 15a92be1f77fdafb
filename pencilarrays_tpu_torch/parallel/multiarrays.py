"""ManyPencilArray — a chain of pencil configurations with one live array.

PyTorch counterpart of the JAX package's ``parallel/multiarrays.py``.
Reference ``src/multiarrays.jl``: M ``PencilArray`` views over ONE flat
buffer sized for the largest configuration (``multiarrays.jl:106-130``),
so ``transpose!(A[i+1], A[i])`` writes into shared memory.  The JAX
package re-specifies that as a chain with exactly one live configuration,
moved by transposes that donate their source buffer; reading a stale
configuration raises.  The port keeps that contract.  Donation drops the
source array's storage (the array then reports ``is_deleted()``), so the
caching allocator can reuse it for the next hop once nothing else holds
the tensor.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .arrays import PencilArray
from .pencil import Pencil
from .transpositions import (AbstractTransposeMethod, AllToAll, Auto,
                             reshard, transpose)

__all__ = ["ManyPencilArray"]


class ManyPencilArray:
    """A chain of pencil configurations sharing one storage budget."""

    def __init__(self, *pencils: Pencil, dtype=torch.float32,
                 extra_dims: Tuple[int, ...] = (),
                 first: Optional[PencilArray] = None):
        if not pencils:
            raise ValueError("need at least one pencil")
        topo = pencils[0].topology
        shape = pencils[0].size_global()
        for p in pencils[1:]:
            if p.topology != topo:
                raise ValueError("all pencils must share a topology")
            if p.size_global() != shape:
                raise ValueError("all pencils must share the global shape")
        self._pencils = tuple(pencils)
        self._index = 0
        if first is not None:
            if first.pencil != pencils[0]:
                raise ValueError("`first` must live on the first pencil")
            self._array = first
        else:
            self._array = PencilArray.zeros(pencils[0], tuple(extra_dims),
                                            dtype)

    # -- queries ---------------------------------------------------------
    @property
    def pencils(self) -> Tuple[Pencil, ...]:
        return self._pencils

    def __len__(self) -> int:
        return len(self._pencils)

    @property
    def index(self) -> int:
        """Index of the live configuration."""
        return self._index

    @property
    def current(self) -> PencilArray:
        return self._array

    @property
    def first(self) -> PencilArray:
        """Reference ``first(A)`` (``multiarrays.jl:40-47``): valid only
        while configuration 0 is live."""
        return self[0]

    @property
    def last(self) -> PencilArray:
        return self[len(self._pencils) - 1]

    def __getitem__(self, i: int) -> PencilArray:
        """Reference ``A[i]`` (``multiarrays.jl:70-79``), restricted to the
        live configuration (stale views are unrepresentable)."""
        if i != self._index:
            raise RuntimeError(
                f"configuration {i} is not live (current: {self._index}); "
                f"call transpose_to({i}) first")
        return self._array

    # -- mutation --------------------------------------------------------
    def set(self, arr: PencilArray) -> None:
        """Install data for whichever configuration ``arr`` lives on."""
        try:
            i = self._pencils.index(arr.pencil)
        except ValueError:
            raise ValueError("array's pencil is not part of this chain")
        self._index = i
        self._array = arr

    def transpose_to(self, i: int, *,
                     method: AbstractTransposeMethod = AllToAll(),
                     donate: bool = True) -> PencilArray:
        """Move the live data to configuration ``i`` (the in-place
        ``transpose!(A[i], A[j])`` of the reference), hopping through the
        intermediate configurations one decomposed dim at a time
        (``Transpositions.jl:182-199``).  With ``donate`` each hop's
        source array gives up its storage.  Every rank calls it."""
        if not 0 <= i < len(self._pencils):
            raise IndexError(f"configuration {i} out of range")
        step = 1 if i > self._index else -1
        while self._index != i:
            nxt = self._index + step
            src = self._array
            self._array = transpose(src, self._pencils[nxt], method=method)
            if donate:
                src._donate()
            self._index = nxt
        return self._array

    def reshard_to(self, i: int, *, donate: bool = True,
                   method: Optional[AbstractTransposeMethod] = None
                   ) -> PencilArray:
        """Jump the live data straight to configuration ``i`` by one
        :func:`~.transpositions.reshard` (the route planner may find a
        cheaper chain than the stored one); the same data as
        :meth:`transpose_to`.  Every rank calls it."""
        if not 0 <= i < len(self._pencils):
            raise IndexError(f"configuration {i} out of range")
        if i == self._index:
            return self._array
        self._array = reshard(self._array, self._pencils[i],
                              method=method if method is not None else Auto(),
                              donate=donate)
        self._index = i
        return self._array

    def cycle(self, *, method: AbstractTransposeMethod = AllToAll()):
        """Generator over the full chain 0 -> 1 -> ... -> M-1, yielding
        each configuration's array (the x->y->z sweep of a PencilFFT)."""
        if self._index != 0:
            self.transpose_to(0, method=method)
        yield self._array
        for i in range(1, len(self._pencils)):
            yield self.transpose_to(i, method=method)

    def __repr__(self) -> str:
        return (f"ManyPencilArray(n={len(self._pencils)}, live={self._index}, "
                f"shape={self._array.shape}, dtype={self._array.dtype})")
