"""Free-function API surface mirroring the reference's exports.

PyTorch counterpart of the JAX package's ``compat.py``.

The reference exposes its accessors as free functions
(``src/PencilArrays.jl:35-39``, ``src/Pencils/Pencils.jl:13-20``):
``pencil(x)``, ``permutation(x)``, ``ndims_extra(x)``, ``range_local(p)``
etc.  The idiomatic Python spelling is methods/properties, which this
framework uses — but a migrating user's code reads far more literally
with the same free functions available, so they are provided here and
re-exported at the package top level.  Each dispatches on
:class:`PencilArray` or :class:`Pencil` exactly like the reference's
multiple dispatch.
"""

from __future__ import annotations

import math
from typing import Tuple, Union

from .parallel.arrays import PencilArray
from .parallel.pencil import IndexOrder, LogicalOrder, Pencil
from .parallel.topology import Topology

__all__ = [
    "pencil",
    "permutation",
    "decomposition",
    "topology",
    "get_comm",
    "timer",
    "extra_dims",
    "ndims_extra",
    "ndims_space",
    "sizeof_global",
    "range_local",
    "range_remote",
    "size_local",
    "size_global",
    "length_local",
    "length_global",
    "to_local",
    "MPITopology",
    "GlobalPencilArray",
    "PencilArrayCollection",
]

# migration aliases (same objects, reference names)
MPITopology = Topology
GlobalPencilArray = PencilArray  # indexing is global here; see global_view

# Reference ``PencilArrayCollection`` (``arrays.jl:183-195``): a tuple of
# same-pencil arrays treated as one multi-component dataset.  Here vector/
# tensor components are first-class via ``extra_dims``; a plain tuple
# remains the spelling for heterogeneous collections.
PencilArrayCollection = Tuple[PencilArray, ...]


def _pen(x: Union[PencilArray, Pencil]) -> Pencil:
    return x.pencil if isinstance(x, PencilArray) else x


def pencil(x: PencilArray) -> Pencil:
    """Reference ``pencil(x)``."""
    return x.pencil


def permutation(x: Union[PencilArray, Pencil]):
    """Reference ``permutation(x)`` (``src/Permutations.jl:5``)."""
    return _pen(x).permutation


def decomposition(x: Union[PencilArray, Pencil]):
    """Reference ``decomposition(p)``."""
    return _pen(x).decomposition


def topology(x: Union[PencilArray, Pencil]) -> Topology:
    """Reference ``topology(p)``."""
    return _pen(x).topology


def get_comm(x) -> object:
    """Reference ``get_comm`` — the communicator is the topology's
    process group (``None`` without ``torch.distributed``)."""
    if isinstance(x, Topology):
        return x.group
    return _pen(x).topology.group


def timer(x: Union[PencilArray, Pencil]):
    """Reference ``timer(p)``."""
    return _pen(x).timer


def extra_dims(x: PencilArray):
    return x.extra_dims


def ndims_extra(x: PencilArray) -> int:
    return x.ndims_extra


def ndims_space(x: PencilArray) -> int:
    return x.ndims_space


def sizeof_global(x: PencilArray) -> int:
    return x.sizeof_global()


def range_local(x, coords=None, order: IndexOrder = LogicalOrder):
    """Ranges of the block at ``coords`` (default: this rank's)."""
    return x.range_local(coords, order)


def range_remote(x, rank_or_coords, order: IndexOrder = LogicalOrder):
    return _pen(x).range_remote(rank_or_coords, order)


def size_local(x, coords=None, order: IndexOrder = LogicalOrder):
    return x.size_local(coords, order)


def size_global(x, order: IndexOrder = LogicalOrder):
    return x.size_global(order)


def length_local(x, coords=None) -> int:
    if isinstance(x, PencilArray):
        return math.prod(x.size_local(coords))
    return x.length_local(coords)


def length_global(x) -> int:
    return x.length_global()


def to_local(x, global_inds, coords=None, order: IndexOrder = LogicalOrder):
    return _pen(x).to_local(global_inds, coords, order)
