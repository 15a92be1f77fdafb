"""Cartesian process topology over ``torch.distributed`` ranks.

PyTorch counterpart of the JAX package's ``parallel/topology.py`` and of the
reference's ``MPITopologies.jl``.  The port runs one process per device in
the SPMD style of the Julia reference:

* the Cartesian communicator is the process group the topology is built on
  (the default group unless ``group=`` is given);
* each 1-D sub-communicator (``MPI.Cart_sub``) is a ``torch.distributed``
  sub-group of the ranks that share every coordinate but one — the role the
  named mesh axes play in the JAX package;
* ranks are row-major positions in the process grid, exactly as the JAX
  package numbers its device grid, so block ``coords`` holds the same data
  in both packages.

Range and size tables need no process group: a topology built before
``init_process_group`` (or in a process that never calls it) answers every
metadata query and only refuses to exchange data.
"""

from __future__ import annotations

import math
import os
from functools import cached_property
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Topology", "dims_create", "default_axis_names", "resolve_device"]


def default_axis_names(ndims: int) -> Tuple[str, ...]:
    """Axis names ``('p1', ..., 'pN')`` — the sub-communicator handles."""
    return tuple(f"p{i + 1}" for i in range(ndims))


def dims_create(nprocs: int, ndims: int) -> Tuple[int, ...]:
    """Balanced factorization of ``nprocs`` into ``ndims`` factors,
    mimicking ``MPI_Dims_create`` (reference ``MPITopologies.jl:138-144``).

    Returns dims sorted in non-increasing order, as MPI does.
    """
    if nprocs <= 0:
        raise ValueError(f"nprocs must be positive, got {nprocs}")
    if ndims <= 0:
        raise ValueError(f"ndims must be positive, got {ndims}")
    dims = [1] * ndims
    # Greedy: repeatedly divide nprocs by its smallest prime factor and
    # multiply it into the currently-smallest dim.
    n = nprocs
    factors = []
    f = 2
    while f * f <= n:
        while n % f == 0:
            factors.append(f)
            n //= f
        f += 1
    if n > 1:
        factors.append(n)
    for f in sorted(factors, reverse=True):
        i = int(np.argmin(dims))
        dims[i] *= f
    return tuple(sorted(dims, reverse=True))


def resolve_device(device=None, rank: Optional[int] = None) -> torch.device:
    """The device a topology's tensors live on.

    ``None`` means the card of this rank: ``cuda:<LOCAL_RANK>`` when the
    launcher sets ``LOCAL_RANK``, else ``cuda:<rank % device_count>``.
    Asking for CUDA where there is none raises; the CPU is used only when
    the caller names it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        local = os.environ.get("LOCAL_RANK")
        index = (int(local) if local is not None
                 else (rank or 0) % torch.cuda.device_count())
        return torch.device("cuda", index)
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is not "
                               f"available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


def _axis_lines(dims: Tuple[int, ...], axis: int):
    """All rank lines along ``axis``: for every coordinate of the other
    axes, the ranks whose ``axis`` coordinate runs 0..dims[axis]-1, in that
    order.  The order of lines is fixed, so every rank creates the
    sub-groups in the same sequence (``new_group`` is collective)."""
    ranks = np.arange(math.prod(dims)).reshape(dims)
    moved = np.moveaxis(ranks, axis, -1).reshape(-1, dims[axis])
    return [tuple(int(r) for r in line) for line in moved]


class Topology:
    """An M-dimensional Cartesian topology of ranks.

    Parity with reference ``MPITopology{N}`` (``MPITopologies.jl:72-92``):

    ========================  ==========================================
    reference                 here
    ========================  ==========================================
    ``get_comm(t)``           :attr:`group`
    ``t.subcomms[i]``         :meth:`subcomm` ``(i)``
    ``t.dims``                :attr:`dims`
    ``t.coords_local``        :attr:`coords_local`
    ``t.ranks``               :attr:`ranks`
    ``length(t)``             :meth:`__len__`
    ``ndims(t)``              :attr:`ndims`
    ========================  ==========================================

    Every rank of ``group`` (default: the default process group) must
    construct the topology, in the same order as its other topologies:
    creating the per-axis sub-groups is a collective call.
    """

    def __init__(self, dims: Sequence[int], *, device=None, group=None):
        dims = tuple(int(d) for d in dims)
        if not dims or any(d <= 0 for d in dims):
            raise ValueError(f"topology dims must be positive: {dims}")
        self._dims = dims
        self._axis_names = default_axis_names(len(dims))
        self._group = None
        self._rank: Optional[int] = None
        self._subgroups: Optional[Tuple] = None
        self._global_ranks: Tuple[int, ...] = tuple(range(len(self)))
        if dist.is_available() and dist.is_initialized():
            self._connect(group)
        elif group is not None:
            raise ValueError("group= given but torch.distributed is not "
                             "initialized")
        self._device = resolve_device(device, self._rank)
        if self._subgroups is not None and \
                dist.get_backend(self._subgroups[0]) == "nccl":
            # NCCL builds a sub-group's communicator at its first
            # collective, and a first batch_isend_irecv must involve every
            # rank of the group; a Ring hop's rounds leave out the ranks
            # that hold only padding, so each communicator is made here
            for g in self._subgroups:
                dist.all_reduce(torch.zeros(1, device=self._device), group=g)

    @classmethod
    def auto(cls, ndims: int, *, device=None, group=None) -> "Topology":
        """Balanced topology over all ranks of ``group`` (one rank without
        ``torch.distributed``) — the analog of ``MPITopology(comm,
        Val(M))`` (``MPITopologies.jl:133-136``)."""
        if dist.is_available() and dist.is_initialized():
            nprocs = dist.get_world_size(group)
        else:
            nprocs = 1
        return cls(dims_create(nprocs, ndims), device=device, group=group)

    @classmethod
    def unconnected(cls, dims: Sequence[int], device=None) -> "Topology":
        """A topology of ``dims`` without process groups, for metadata and
        pricing only (building it is not collective, whatever the
        process group): the probe grids of ``decomposition="auto"``."""
        t = cls.__new__(cls)
        t._dims = tuple(int(d) for d in dims)
        t._axis_names = default_axis_names(len(t._dims))
        t._group = t._rank = t._subgroups = None
        t._global_ranks = tuple(range(len(t)))
        t._device = torch.device(device) if device is not None \
            else torch.device("cpu")
        return t

    def _connect(self, group) -> None:
        group = dist.group.WORLD if group is None else group
        ranks = tuple(dist.get_process_group_ranks(group))
        if len(ranks) != len(self):
            raise ValueError(
                f"topology {self._dims} needs exactly {len(self)} ranks, the "
                f"process group has {len(ranks)}")
        backend = dist.get_backend(group)
        me = dist.get_rank(group)
        subgroups = []
        for axis in range(len(self._dims)):
            mine = None
            for line in _axis_lines(self._dims, axis):
                g = dist.new_group([ranks[r] for r in line], backend=backend)
                if me in line:
                    mine = g
            subgroups.append(mine)
        self._group = group
        self._rank = me
        self._subgroups = tuple(subgroups)
        self._global_ranks = ranks
        coords = self.coords(me)
        for axis, g in enumerate(subgroups):
            if dist.get_rank(g) != coords[axis]:
                raise RuntimeError(
                    f"sub-group rank {dist.get_rank(g)} of axis {axis} does "
                    f"not match coordinate {coords[axis]}")

    # -- accessors --------------------------------------------------------
    @property
    def dims(self) -> Tuple[int, ...]:
        return self._dims

    @property
    def ndims(self) -> int:
        return len(self._dims)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return self._axis_names

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def group(self):
        """The process group of the whole topology (``None`` without
        ``torch.distributed``)."""
        return self._group

    @property
    def connected(self) -> bool:
        """Whether this topology can exchange data (has process groups)."""
        return self._subgroups is not None

    @property
    def rank_local(self) -> int:
        """This process's rank in the topology (0 without a process
        group, where only a 1-rank topology can hold data)."""
        if self._rank is None:
            if len(self) != 1:
                raise RuntimeError(
                    f"topology {self._dims} has {len(self)} ranks but "
                    f"torch.distributed is not initialized")
            return 0
        return self._rank

    @property
    def coords_local(self) -> Tuple[int, ...]:
        return self.coords(self.rank_local)

    def __len__(self) -> int:
        return math.prod(self._dims)

    @cached_property
    def ranks(self) -> np.ndarray:
        """Linear rank of each coordinate (reference ``t.ranks``,
        ``MPITopologies.jl:208-226``): row-major positions in the grid."""
        return np.arange(len(self)).reshape(self._dims)

    def coords(self, rank: int) -> Tuple[int, ...]:
        """Cartesian coordinates of a linear rank."""
        return tuple(int(c) for c in np.unravel_index(rank, self._dims))

    def rank(self, coords: Sequence[int]) -> int:
        """Linear rank of Cartesian coordinates (``MPI.Cart_rank``)."""
        return int(np.ravel_multi_index(tuple(coords), self._dims))

    def subcomm(self, i: int):
        """The sub-group of ranks along topology axis ``i`` — the role of
        the reference's ``subcomms[i]``."""
        if self._subgroups is None:
            raise RuntimeError(
                "topology has no process groups: call "
                "torch.distributed.init_process_group before building it")
        return self._subgroups[i]

    def global_rank(self, rank: int) -> int:
        """Rank in the default group of topology rank ``rank``."""
        return self._global_ranks[rank]

    # -- comparison -------------------------------------------------------
    def __eq__(self, other) -> bool:
        if not isinstance(other, Topology):
            return NotImplemented
        return (self._dims == other._dims
                and self._device == other._device
                and self._global_ranks == other._global_ranks)

    def __hash__(self) -> int:
        return hash((self._dims, str(self._device), self._global_ranks))

    def __repr__(self) -> str:
        return (f"Topology(dims={self._dims}, axes={self._axis_names}, "
                f"device={self._device})")
