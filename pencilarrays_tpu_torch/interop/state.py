"""State carried across from the JAX package, and back.

The JAX package stores a distributed array as ONE global, padded,
memory-order array (``PencilArray.data``, sharded over its mesh); the port
stores each rank's block of that same array.  These two functions convert
between them through NumPy (``np.asarray(jax_array.data)``), so both
packages can be fed the same state and their results compared bit for
bit, padding included.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from ..parallel.arrays import PencilArray, numpy_to_torch
from ..parallel.gather import gather_blocks, tensor_to_numpy
from ..parallel.pencil import MemoryOrder, Pencil

__all__ = ["block_slices", "from_numpy_padded", "to_numpy_padded"]


def block_slices(pencil: Pencil, coords: Sequence[int]) -> Tuple[slice, ...]:
    """Memory-order slices of block ``coords`` in the padded global
    memory-order array."""
    blk_logical = pencil.padded_size_local()
    starts = []
    for d in range(pencil.ndims):
        try:
            i = pencil.decomposition.index(d)
        except ValueError:
            starts.append(0)
        else:
            starts.append(coords[i] * blk_logical[d])
    starts = pencil.permutation.apply(tuple(starts))
    blk = pencil.padded_size_local(MemoryOrder)
    return tuple(slice(s, s + n) for s, n in zip(starts, blk))


def from_numpy_padded(pencil: Pencil, padded_global_memory_order,
                      extra_dims: Tuple[int, ...] = ()) -> PencilArray:
    """This rank's PencilArray from the JAX package's global padded
    memory-order array (``np.asarray(pa.data)``, or a CPU tensor)."""
    arr = numpy_to_torch(padded_global_memory_order)
    expected = pencil.padded_size_global(MemoryOrder) + tuple(extra_dims)
    if tuple(arr.shape) != expected:
        raise ValueError(f"array shape {tuple(arr.shape)} != padded global "
                         f"memory shape {expected}")
    block = arr[block_slices(pencil, pencil.topology.coords_local)]
    data = block.contiguous().to(pencil.topology.device)
    return PencilArray(pencil, data, tuple(extra_dims))


def to_numpy_padded(x: PencilArray) -> np.ndarray:
    """The global padded memory-order array (the layout of the JAX
    package's ``PencilArray.data``) on every rank.  Every rank must call
    it; ``bfloat16`` comes back as ``float32`` (exactly)."""
    pen = x.pencil
    blocks = gather_blocks(x, None)
    out = None
    for rank, blk in enumerate(blocks):
        blk = tensor_to_numpy(blk)
        if out is None:
            out = np.empty(pen.padded_size_global(MemoryOrder) + x.extra_dims,
                           blk.dtype)
        out[block_slices(pen, pen.topology.coords(rank))] = blk
    return out
