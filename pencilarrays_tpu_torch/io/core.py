"""Parallel I/O driver abstraction.

PyTorch counterpart of the JAX package's ``io/core.py`` (reference
``src/PencilIO/PencilIO.jl``): a ``ParallelIODriver`` interface with
``open(f, driver, filename, comm; keywords...)`` (``PencilIO.jl:18-51``) and
a ``metadata(x)`` helper recording decomposition facts next to the data
(``PencilIO.jl:53-65``), so files are self-describing and re-readable under
a different process configuration.

The port runs one process per device, as the reference runs one per MPI
rank, so an open takes the reference's communicator back: ``comm`` is the
``torch.distributed`` process group whose ranks share the file (the default
group unless given).  Every rank of ``comm`` opens, writes and closes
together; each writes and reads its own block, and rank 0 alone writes the
metadata, between named barriers.  The files are those of the JAX package,
byte for byte, so either package reads what the other wrote, under any
decomposition and any number of ranks (``mpi_io.jl:159-167``).
"""

from __future__ import annotations

import functools
import math
from contextlib import contextmanager
from typing import Dict

import torch

from ..parallel.arrays import PencilArray
from ..utils.permutations import NO_PERMUTATION

__all__ = ["ParallelIODriver", "open_file", "metadata", "CollectionView",
           "pack_collection", "maybe_unstack"]


class ParallelIODriver:
    """Base class for I/O drivers (reference ``ParallelIODriver``)."""

    def open(self, filename: str, *, write: bool = False, read: bool = False,
             create: bool = False, append: bool = False,
             truncate: bool = False, comm=None):
        raise NotImplementedError


@contextmanager
def open_file(driver: ParallelIODriver, filename: str, retry=None,
              comm=None, **mode):
    """``open(f, driver, filename, comm; mode...)`` of the reference
    (``PencilIO.jl:18-51``) as a context manager.

    The open is consulted by the ``io.open`` fault-injection point and
    retried under ``retry`` (default
    :meth:`~pencilarrays_tpu_torch.resilience.RetryPolicy.from_env`) — a
    transient filesystem error at open time backs off instead of
    crashing the job; non-transient errors (missing file, permission)
    propagate immediately.  EXCEPT multi-rank *writable* opens: those run
    a collective barrier inside the driver, and a one-sided retry would
    re-enter it while peers have advanced to a later named barrier
    (deadlock) — so the collective case fails fast instead."""
    from ..parallel.distributed import is_multiprocess
    from ..resilience import faults
    from ..resilience.retry import RetryPolicy

    policy = retry or RetryPolicy.from_env()
    writable = any(mode.get(k) for k in ("write", "append", "create",
                                         "truncate"))
    if writable and is_multiprocess(comm):
        policy = policy.replace(max_attempts=1)

    def _open():
        faults.fire("io.open", path=filename)
        return driver.open(filename, comm=comm, **mode)

    f = policy.call(_open, label=f"open {filename}")
    from .. import obs

    if obs.enabled():
        obs.counter("io.opens", driver=type(driver).__name__,
                    mode="write" if writable else "read").inc()
        obs.record_event("io.open", path=str(filename),
                         mode="write" if writable else "read",
                         driver=type(driver).__name__)
    try:
        yield f
    finally:
        f.close()


def metadata(x, collection: int = None) -> Dict:
    """Decomposition metadata stored next to each dataset
    (reference ``PencilIO.metadata``, ``PencilIO.jl:53-65``), as the JAX
    package records it.  ``collection`` records that the trailing extra
    dim stacks that many logical fields (collection-level I/O)."""
    pen = x.pencil
    perm = pen.permutation
    md = {
        "permutation": None if perm is NO_PERMUTATION or perm.is_identity()
        else list(perm.axes()),
        "extra_dims": list(x.extra_dims),
        "decomposed_dims": list(pen.decomposition),
        "process_dims": list(pen.topology.dims),
    }
    if collection:
        md["collection"] = int(collection)
    return md


class CollectionView:
    """A zero-copy stand-in for ``PencilArray.stack(components)`` that
    the write paths consume: it exposes the stacked array's descriptor
    surface (pencil, dtype, ``extra_dims + (n,)``, global sizes) while the
    stacking happens in the host block, one component staged at a time
    — never a stacked duplicate in device memory (which would double the
    peak at exactly the checkpoint moment the collection feature
    targets)."""

    def __init__(self, components):
        first = components[0]
        for c in components[1:]:
            if not isinstance(c, PencilArray) or c.pencil != first.pencil \
                    or c.extra_dims != first.extra_dims:
                raise ValueError(
                    "collection components must share pencil/extra dims")
        self.components = tuple(components)
        self.pencil = first.pencil
        self.extra_dims = first.extra_dims + (len(components),)
        self.dtype = functools.reduce(torch.promote_types,
                                      (c.dtype for c in components))

    @property
    def ndims_extra(self) -> int:
        return len(self.extra_dims)

    def sizeof_global(self) -> int:
        n = math.prod(self.pencil.size_global()) * math.prod(self.extra_dims)
        return n * torch.empty((), dtype=self.dtype).element_size()


def pack_collection(x):
    """Normalize a driver ``write`` input: a tuple/list of same-pencil
    arrays (reference ``PencilArrayCollection``, ``arrays.jl:183-195``)
    becomes ONE dataset with a trailing component dim
    (``ext/PencilArraysHDF5Ext.jl:222-229``) so a multi-field state
    (u, v, w, p) restarts consistently in one call.  Returns
    ``(PencilArray | CollectionView, n_components or None)`` — the view
    stages one component at a time, no stacked device copy."""
    if isinstance(x, (tuple, list)):
        if not x:
            raise ValueError("cannot write an empty collection")
        bad = [type(a).__name__ for a in x
               if not isinstance(a, PencilArray)]
        if bad:
            raise TypeError(
                f"collection elements must be PencilArrays sharing a "
                f"pencil; got {bad}")
        return CollectionView(list(x)), len(x)
    return x, None


def maybe_unstack(x: PencilArray, md: Dict):
    """Read-side inverse of :func:`pack_collection`: return a tuple of
    components when the stored metadata marks a collection."""
    n = (md or {}).get("collection")
    if n:
        comps = x.unstack()
        if len(comps) != n:
            raise ValueError(
                f"collection metadata says {n} components, trailing dim "
                f"has {len(comps)}")
        return comps
    return x
