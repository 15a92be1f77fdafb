"""Pencil (block) decomposition descriptor.

PyTorch counterpart of the JAX package's ``parallel/pencil.py`` (reference
``src/Pencils/Pencils.jl``, ``data_ranges.jl``, ``index_orders.jl``).

A :class:`Pencil` describes how an N-dimensional global array is decomposed
over an M-dimensional :class:`~pencilarrays_tpu_torch.parallel.topology.
Topology` along ``M <= N`` chosen *logical* dimensions, with an optional
:class:`~pencilarrays_tpu_torch.utils.permutations.Permutation` selecting
the *memory* order of each rank's local block.

The block rule is the JAX package's ceil-block rule, not the reference's
balanced one: with ``b = ceil(n / P)`` block ``p`` owns
``[p*b, min((p+1)*b, n))`` and every rank stores a block of ``b`` rows,
the tail padded with zeros.  Keeping the JAX rule makes each rank's local
tensor bit-identical to the JAX package's shard for the same pencil, and
keeps the exchange a pad -> all-to-all -> slice pipeline of equal tiles.

All of this is metadata: nothing here needs an initialized process group.
"""

from __future__ import annotations

import enum
import math
import warnings
from functools import cached_property
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.permutations import (
    AbstractPermutation,
    PermutationLike,
    as_permutation,
)
from .topology import Topology

__all__ = [
    "IndexOrder",
    "MemoryOrder",
    "LogicalOrder",
    "Pencil",
    "make_pencil",
    "local_data_range",
    "complete_dims",
]


class IndexOrder(enum.Enum):
    """Which of the two index views an accessor returns
    (reference ``index_orders.jl:9-27``; default is logical)."""

    LOGICAL = "logical"
    MEMORY = "memory"


LogicalOrder = IndexOrder.LOGICAL
MemoryOrder = IndexOrder.MEMORY


def local_data_range(p: int, P: int, n: int) -> range:
    """Range of global indices owned by block ``p`` (0-based) of ``P`` along a
    dim of true size ``n`` — the ceil-block rule (may be empty for tail
    blocks when ``P`` approaches or exceeds ``n``)."""
    b = -(-n // P)  # ceil
    lo = min(p * b, n)
    hi = min((p + 1) * b, n)
    return range(lo, hi)


def complete_dims(ndims: int, decomp_dims: Sequence[int],
                  vals: Sequence[int], fill: int = 1) -> Tuple[int, ...]:
    """Scatter per-decomposed-dim values into a full ``ndims`` tuple,
    padding undecomposed dims with ``fill`` (reference
    ``data_ranges.jl:15-26``)."""
    out = [fill] * ndims
    for d, v in zip(decomp_dims, vals):
        out[d] = v
    return tuple(out)


class Pencil:
    """Decomposition descriptor (reference ``Pencil{N,M,P}``,
    ``Pencils.jl:151-192``).

    ``decomp_dims[i]`` is split over topology axis ``i``; the default is the
    *last* ``M`` dims, the reference's ``default_decomposition``.
    ``permutation`` maps logical to memory order (``None`` = identity).
    """

    def __init__(self, topology: Topology, global_shape: Sequence[int],
                 decomp_dims: Optional[Sequence[int]] = None, *,
                 permutation: PermutationLike = None, timer=None):
        global_shape = tuple(int(n) for n in global_shape)
        if any(n < 0 for n in global_shape):
            raise ValueError(f"invalid global shape {global_shape}")
        N = len(global_shape)
        M = topology.ndims
        if decomp_dims is None:
            decomp_dims = tuple(range(N - M, N))
        decomp_dims = tuple(int(d) for d in decomp_dims)
        self._check_selected_dimensions(N, M, decomp_dims)
        self._topology = topology
        self._global_shape = global_shape
        self._decomp_dims = decomp_dims
        self._perm = as_permutation(permutation, N)
        self.timer = timer  # shared, excluded from eq/hash (Pencils.jl:191)
        self._warn_empty_ranks()

    # -- validation -------------------------------------------------------
    @staticmethod
    def _check_selected_dimensions(N: int, M: int, decomp: Tuple[int, ...]):
        # Mirrors ``Pencils.jl:393-406``.
        if len(decomp) != M:
            raise ValueError(
                f"number of decomposed dims ({len(decomp)}) must match "
                f"topology ndims ({M})"
            )
        if len(set(decomp)) != len(decomp):
            raise ValueError(f"decomposed dims must be unique: {decomp}")
        for d in decomp:
            if not (0 <= d < N):
                raise ValueError(f"decomposed dim {d} out of range 0..{N-1}")

    def _warn_empty_ranks(self):
        # Reference warns when P_i > N_i leaves ranks without data
        # (``Pencils.jl:193-218``); same text as the JAX package.
        for d, P in zip(self._decomp_dims, self._topology.dims):
            n = self._global_shape[d]
            b = -(-n // P) if P else 0
            if P > 1 and (n == 0 or (P - 1) * b >= n):
                warnings.warn(
                    f"Pencil: decomposed dim {d} (size {n}) over {P} devices "
                    f"leaves some devices with no data; performance will "
                    f"suffer (cf. reference Pencils.jl:193-218)",
                    stacklevel=3,
                )

    # -- basic accessors --------------------------------------------------
    @property
    def topology(self) -> Topology:
        return self._topology

    @property
    def ndims(self) -> int:
        return len(self._global_shape)

    @property
    def decomposition(self) -> Tuple[int, ...]:
        """Decomposed logical dims (reference ``decomposition(p)``)."""
        return self._decomp_dims

    @property
    def permutation(self) -> AbstractPermutation:
        return self._perm

    def decomp_axis_name(self, dim: int) -> Optional[str]:
        """Topology axis name splitting logical dim ``dim`` (None if local)."""
        try:
            i = self._decomp_dims.index(dim)
        except ValueError:
            return None
        return self._topology.axis_names[i]

    def proc_count(self, dim: int) -> int:
        """Number of blocks along logical dim ``dim`` (1 if not decomposed)."""
        try:
            i = self._decomp_dims.index(dim)
        except ValueError:
            return 1
        return self._topology.dims[i]

    # -- shapes -----------------------------------------------------------
    def size_global(self, order: IndexOrder = LogicalOrder) -> Tuple[int, ...]:
        """True global shape (reference ``size_global``, ``Pencils.jl:555-559``)."""
        if order is MemoryOrder:
            return self._perm.apply(self._global_shape)
        return self._global_shape

    @cached_property
    def padded_global_shape(self) -> Tuple[int, ...]:
        """Global logical shape with each decomposed dim rounded up to a
        multiple of its process count."""
        out = list(self._global_shape)
        for d, P in zip(self._decomp_dims, self._topology.dims):
            out[d] = P * (-(-out[d] // P)) if out[d] else 0
        return tuple(out)

    def padded_size_global(self, order: IndexOrder = LogicalOrder):
        if order is MemoryOrder:
            return self._perm.apply(self.padded_global_shape)
        return self.padded_global_shape

    def range_local(self, coords: Sequence[int] = None,
                    order: IndexOrder = LogicalOrder) -> Tuple[range, ...]:
        """Global index ranges owned by the block at topology ``coords``
        (default: this rank's); reference ``range_local``
        (``Pencils.jl:512-514``)."""
        if coords is None:
            coords = self._topology.coords_local
        ranges = []
        for d, n in enumerate(self._global_shape):
            try:
                i = self._decomp_dims.index(d)
            except ValueError:
                ranges.append(range(0, n))
            else:
                ranges.append(local_data_range(coords[i],
                                               self._topology.dims[i], n))
        t = tuple(ranges)
        return self._perm.apply(t) if order is MemoryOrder else t

    def range_remote(self, rank_or_coords,
                     order: IndexOrder = LogicalOrder) -> Tuple[range, ...]:
        """Ranges owned by an arbitrary rank (reference ``range_remote``,
        ``Pencils.jl:529-536``)."""
        if isinstance(rank_or_coords, (int, np.integer)):
            coords = self._topology.coords(int(rank_or_coords))
        else:
            coords = tuple(rank_or_coords)
        return self.range_local(coords, order)

    @cached_property
    def axes_all(self):
        """Owner table: an object-array over topology dims whose entry at
        ``coords`` is the logical-order range tuple owned by that block
        (reference ``generate_axes_matrix``, ``data_ranges.jl:30-45``)."""
        out = np.empty(self._topology.dims, dtype=object)
        for rank in range(len(self._topology)):
            coords = self._topology.coords(rank)
            out[coords] = self.range_local(coords, LogicalOrder)
        return out

    def size_local(self, coords: Sequence[int] = None,
                   order: IndexOrder = LogicalOrder) -> Tuple[int, ...]:
        """True (unpadded) block shape at ``coords`` (default: this rank's);
        reference ``size_local`` (``Pencils.jl:546-551``)."""
        return tuple(len(r) for r in self.range_local(coords, order))

    def padded_size_local(self, order: IndexOrder = LogicalOrder):
        """Shape every rank stores: the block with tail padding."""
        out = tuple(n // self.proc_count(d)
                    for d, n in enumerate(self.padded_global_shape))
        return self._perm.apply(out) if order is MemoryOrder else out

    def length_global(self) -> int:
        return math.prod(self._global_shape)

    def length_local(self, coords=None) -> int:
        return math.prod(self.size_local(coords))

    def to_local(self, global_inds: Sequence[int], coords: Sequence[int] = None,
                 order: IndexOrder = LogicalOrder) -> Tuple[int, ...]:
        """Convert global indices to indices local to the block at ``coords``
        (reference ``to_local``, ``Pencils.jl:579-587``)."""
        ranges = self.range_local(coords, order)
        return tuple(int(i) - r.start for i, r in zip(global_inds, ranges))

    # -- derivation -------------------------------------------------------
    def bytes_per_device(self, extra_dims: Sequence[int] = (),
                         dtype=None, *, isize: Optional[int] = None) -> int:
        """Bytes per rank of the padded block (extra dims included): the
        unit of the route planner's peak-memory bound."""
        if isize is None:
            isize = (torch.empty((), dtype=dtype).element_size()
                     if isinstance(dtype, torch.dtype) else
                     np.dtype(dtype if dtype is not None
                              else np.float32).itemsize)
        n = math.prod(self.padded_size_local(LogicalOrder))
        for e in extra_dims:
            n *= int(e)
        return n * int(isize)

    def replace(self, *, decomp_dims=None, permutation="keep",
                global_shape=None, timer="keep") -> "Pencil":
        """Derive a new pencil sharing this topology (reference
        ``Pencil(p; decomp_dims, permute)``, ``Pencils.jl:257-271``)."""
        return Pencil(
            self._topology,
            self._global_shape if global_shape is None else global_shape,
            self._decomp_dims if decomp_dims is None else decomp_dims,
            permutation=self._perm if permutation == "keep" else permutation,
            timer=self.timer if timer == "keep" else timer,
        )

    # -- comparison / hashing --------------------------------------------
    def _key(self):
        return (self._topology, self._global_shape, self._decomp_dims,
                self._perm)

    def __eq__(self, other) -> bool:
        if not isinstance(other, Pencil):
            return NotImplemented
        return self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return (
            f"Pencil(shape={self._global_shape}, decomp={self._decomp_dims}, "
            f"topo={self._topology.dims}, perm={self._perm})"
        )


def make_pencil(global_shape: Sequence[int],
                ndims_decomp: Optional[int] = None, *, device=None,
                group=None, permutation: PermutationLike = None,
                timer=None) -> Pencil:
    """Balanced topology over all ranks decomposing the last
    ``ndims_decomp`` dims (default ``N - 1``) — the analog of
    ``Pencil(dims_global, comm)`` (``Pencils.jl:274-280``)."""
    N = len(global_shape)
    if ndims_decomp is None:
        ndims_decomp = max(N - 1, 1)
    topo = Topology.auto(ndims_decomp, device=device, group=group)
    return Pencil(topo, global_shape, permutation=permutation, timer=timer)
