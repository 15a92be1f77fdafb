"""Distributed reductions over PencilArrays.

PyTorch counterpart of the JAX package's ``ops/reductions.py`` (reference
``src/reductions.jl``): reduce this rank's block with its tail padding
masked (the identity of the reduction written into it, so padding that
holds garbage or NaN never leaks in), then ``all_reduce`` across the
topology, so every rank gets the same global value — the property that
makes adaptive time stepping agree across ranks.

Where the collective libraries lack an operation:

* NCCL and gloo have no boolean reduce, so ``any``/``all`` reduce a
  ``uint8`` with MAX/MIN;
* a complex ``sum`` all-reduces its ``view_as_real`` pair;
* a product gathers every rank's partial product and multiplies them in
  rank order (NCCL has no complex product, and one order gives every
  rank the same bits).

All functions reduce in *memory order* over the blocks, like the
reference's parent-level reductions; every one returns a 0-dim tensor on
the topology's device, and every rank of the topology must call it.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.distributed as dist

from ..parallel.arrays import PencilArray
from ..parallel.pencil import MemoryOrder

__all__ = [
    "mapreduce",
    "sum",
    "mean",
    "prod",
    "minimum",
    "maximum",
    "any",
    "all",
    "norm",
    "dot",
    "count_nonzero",
    "extrema",
]

# local reduction -> how the ranks' partial results combine
_OPS = {
    torch.sum: dist.ReduceOp.SUM,
    torch.prod: None,                 # gathered, multiplied in rank order
    torch.amax: dist.ReduceOp.MAX,
    torch.amin: dist.ReduceOp.MIN,
    torch.any: dist.ReduceOp.MAX,     # over uint8
    torch.all: dist.ReduceOp.MIN,     # over uint8
}


def _order_identity(dtype: torch.dtype, kind: str):
    """Neutral element for min/max over ``dtype`` (written into padding)."""
    if dtype.is_complex:
        raise TypeError(f"no ordering for complex dtype {dtype}")
    if dtype == torch.bool:
        return kind == "min"  # True for min, False for max
    if dtype.is_floating_point:
        return math.inf if kind == "min" else -math.inf
    info = torch.iinfo(dtype)
    return info.max if kind == "min" else info.min


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


def _combine(local: torch.Tensor, op: Callable, group) -> torch.Tensor:
    """Every rank's ``local`` combined by ``op``'s rule, on every rank."""
    if op is torch.prod:
        parts = [torch.empty_like(local) for _ in range(
            dist.get_world_size(group))]
        if local.is_complex():
            dist.all_gather([torch.view_as_real(p) for p in parts],
                            torch.view_as_real(local), group=group)
        else:
            dist.all_gather(parts, local, group=group)
        out = parts[0]
        for p in parts[1:]:
            out = out * p
        return out
    if local.dtype == torch.bool:     # any/all, min/max of bools
        flag = local.to(torch.uint8)
        dist.all_reduce(flag, op=_OPS[op], group=group)
        return flag.bool()
    buf = torch.view_as_real(local) if local.is_complex() else local
    dist.all_reduce(buf, op=_OPS[op], group=group)
    return local


def mapreduce(f: Callable, op: Callable, *arrays: PencilArray,
              identity) -> torch.Tensor:
    """``op``-reduce of ``f`` applied elementwise over aligned PencilArrays
    (reference zipped mapreduce, ``reductions.jl:21-27``).  ``op`` is one
    of ``torch.sum``, ``torch.prod``, ``torch.amax``, ``torch.amin``,
    ``torch.any``, ``torch.all``; ``identity`` is its neutral element,
    written into padding."""
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
        local = _combine(local, op, topo.group)
    return local


def sum(x: PencilArray, *, dtype=None) -> torch.Tensor:
    return mapreduce(lambda d: d if dtype is None else d.to(dtype),
                     torch.sum, x, identity=0)


def prod(x: PencilArray) -> torch.Tensor:
    return mapreduce(lambda d: d, torch.prod, x, identity=1)


def mean(x: PencilArray) -> torch.Tensor:
    return sum(x) / x.length_global()


def minimum(x: PencilArray) -> torch.Tensor:
    return mapreduce(lambda d: d, torch.amin, x,
                     identity=_order_identity(x.dtype, "min"))


def maximum(x: PencilArray) -> torch.Tensor:
    return mapreduce(lambda d: d, torch.amax, x,
                     identity=_order_identity(x.dtype, "max"))


def extrema(x: PencilArray):
    """Global ``(min, max)`` pair (Julia ``extrema``)."""
    return minimum(x), maximum(x)


def any(x: PencilArray, pred: Optional[Callable] = None) -> torch.Tensor:
    """Global ``any`` (reference ``reductions.jl:30-38``: Allreduce with
    ``|``).  With ``pred``, tests ``pred(x)`` elementwise first."""
    f = (lambda d: pred(d).bool()) if pred else (lambda d: d.bool())
    return mapreduce(f, torch.any, x, identity=False)


def all(x: PencilArray, pred: Optional[Callable] = None) -> torch.Tensor:
    f = (lambda d: pred(d).bool()) if pred else (lambda d: d.bool())
    return mapreduce(f, torch.all, x, identity=True)


def count_nonzero(x: PencilArray) -> torch.Tensor:
    return mapreduce(lambda d: (d != 0).to(torch.int64), torch.sum, x,
                     identity=0)


def norm(x: PencilArray, ord=2) -> torch.Tensor:
    """Global p-norm (what adaptive error control needs to be
    decomposition-independent, cf. ``ext/PencilArraysDiffEqExt.jl:5-9``)."""
    if ord == 2:
        return torch.sqrt(mapreduce(lambda d: d.abs() ** 2, torch.sum, x,
                                    identity=0))
    if ord == 1:
        return mapreduce(lambda d: d.abs(), torch.sum, x, identity=0)
    if ord == math.inf:
        return mapreduce(lambda d: d.abs(), torch.amax, x, identity=0)
    return mapreduce(lambda d: d.abs() ** ord, torch.sum, x,
                     identity=0) ** (1.0 / ord)


def dot(x: PencilArray, y: PencilArray) -> torch.Tensor:
    """Global inner product ``<x, y>`` (conjugating the first argument for
    complex dtypes)."""
    return mapreduce(lambda a, b: torch.conj_physical(a) * b, torch.sum, x, y,
                     identity=0)
