"""Gather a distributed array to one rank — verification/debug path.

Reference ``src/gather.jl``: every rank sends its block to the root, which
assembles the global array (``gather.jl:17-100``).  The port does the same
over ``torch.distributed.gather``; blocks travel as raw bytes at their
padded extents, so every rank sends the same size.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .arrays import PencilArray, _inv_axes
from .pencil import LogicalOrder, MemoryOrder

__all__ = ["gather", "tensor_to_numpy"]


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A NumPy copy of ``t``; ``bfloat16`` becomes ``float32`` (exactly)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy().copy()


def gather_blocks(x: PencilArray, root: Optional[int]):
    """Every rank's padded memory-order block, in rank order, on ``root``
    (on every rank when ``root`` is None); ``None`` on the other ranks."""
    topo = x.pencil.topology
    if not topo.connected:
        return [x.data]
    src = x.data.contiguous().reshape(-1).view(torch.uint8)
    bufs = [torch.empty_like(src) for _ in range(len(topo))]
    if root is None:
        dist.all_gather(bufs, src, group=topo.group)
    else:
        mine = topo.rank_local == root
        dist.gather(src, bufs if mine else None, dst=topo.global_rank(root),
                    group=topo.group)
        if not mine:
            return None
    return [b.view(x.dtype).reshape(x.data.shape) for b in bufs]


def gather(x: PencilArray, root: int = 0) -> Optional[np.ndarray]:
    """The full global array (logical order, true shape) as NumPy on rank
    ``root``; ``None`` on the other ranks.  Every rank must call it."""
    blocks = gather_blocks(x, root)
    if blocks is None:
        return None
    pen = x.pencil
    nx = x.ndims_extra
    out = None
    for rank, blk in enumerate(blocks):
        coords = pen.topology.coords(rank)
        true_mem = pen.size_local(coords, MemoryOrder)
        blk = blk[tuple(slice(0, n) for n in true_mem)]
        blk = tensor_to_numpy(blk.permute(_inv_axes(pen, nx)))
        if out is None:
            out = np.empty(pen.size_global(LogicalOrder) + x.extra_dims,
                           blk.dtype)
        out[tuple(slice(r.start, r.stop)
                  for r in pen.range_local(coords, LogicalOrder))] = blk
    return out
