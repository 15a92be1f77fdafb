"""Distributed reductions over PencilArrays.

PyTorch counterpart of the JAX package's ``ops/reductions.py`` (reference
``src/reductions.jl``): reduce this rank's block with its tail padding
masked, then ``all_reduce`` across the topology, so every rank gets the
same global value.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from ..parallel.arrays import PencilArray
from ..parallel.pencil import MemoryOrder

__all__ = ["mapreduce", "sum"]

_OPS = {
    torch.sum: dist.ReduceOp.SUM,
    torch.prod: dist.ReduceOp.PRODUCT,
    torch.amax: dist.ReduceOp.MAX,
    torch.amin: dist.ReduceOp.MIN,
}


def _valid_mask(x: PencilArray):
    """Boolean mask over this rank's padded memory-order block: True on
    true data, False on tail padding (``None`` when nothing is padded)."""
    pen = x.pencil
    padded = pen.padded_size_local(MemoryOrder)
    true = pen.size_local(order=MemoryOrder)
    mask = None
    for d, (n_pad, n_true) in enumerate(zip(padded, true)):
        if n_pad == n_true:
            continue
        shape = [1] * (len(padded) + x.ndims_extra)
        shape[d] = n_pad
        m = (torch.arange(n_pad, device=x.device) < n_true).reshape(shape)
        mask = m if mask is None else mask & m
    return mask


def mapreduce(f: Callable, op: Callable, *arrays: PencilArray,
              identity) -> torch.Tensor:
    """``op``-reduce of ``f`` applied elementwise over aligned PencilArrays
    (reference zipped mapreduce, ``reductions.jl:21-27``).  ``op`` is one
    of ``torch.sum``, ``torch.prod``, ``torch.amax``, ``torch.amin``;
    ``identity`` is its neutral element, written into padding."""
    if op not in _OPS:
        raise ValueError(f"unsupported reduction {op!r}")
    x0 = arrays[0]
    for a in arrays[1:]:
        if a.pencil != x0.pencil or a.extra_dims != x0.extra_dims:
            raise ValueError("mapreduce operands must share pencil/extra dims")
    val = f(*(a.data for a in arrays))
    mask = _valid_mask(x0)
    if mask is not None:
        val = torch.where(mask, val, torch.as_tensor(identity, dtype=val.dtype,
                                                     device=val.device))
    local = op(val)
    topo = x0.pencil.topology
    if topo.connected and len(topo) > 1:
        buf = torch.view_as_real(local) if local.is_complex() else local
        dist.all_reduce(buf, op=_OPS[op], group=topo.group)
    return local


def sum(x: PencilArray) -> torch.Tensor:
    return mapreduce(lambda d: d, torch.sum, x, identity=0)

