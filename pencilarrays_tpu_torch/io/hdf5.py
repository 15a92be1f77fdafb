"""HDF5 driver — parity with the reference's parallel-HDF5 extension.

PyTorch counterpart of the JAX package's ``io/hdf5.py`` (reference
``src/PencilIO/hdf5.jl`` + ``ext/PencilArraysHDF5Ext.jl``): each array is
one HDF5 dataset in *logical order* written by hyperslab selections
(``dset[range_local(x)...] = x``, ``ext:113-118``), with decomposition
metadata stored as JSON dataset attributes (``ext:127-133``) — the JAX
package's layout, so plain h5py reads it and either package restarts from
the other's file under any decomposition.

One rank writes the file directly.  Several ranks (the MPIO-parallel
analog): h5py has no MPIO, and concurrent writes to one HDF5 file corrupt
it, so each rank writes its block into its OWN shard file
(``<file>.r<rank>``, dataset ``<name>/r<topology rank>``), and after a
barrier rank 0 stitches them into the master file as an HDF5 **virtual
dataset** (``h5py.VirtualLayout``): one logical dataset any HDF5 consumer
reads transparently — the JAX package's multi-process layout, built here
from pencil math alone.  Reads always go through the master, each rank
reading its own hyperslab.

A block moves between device and host as in the binary driver (one K1
permute and one copy).  bfloat16, which HDF5 cannot hold natively, is
stored as its uint16 bit pattern with a ``pa_dtype`` marker attribute.
The dependency is optional (gated import), as in the JAX package.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Optional, Tuple

import torch.distributed as dist

from ..parallel.distributed import (is_multiprocess, process_index,
                                    sync_global_devices)
from ..parallel.pencil import LogicalOrder, Pencil, local_data_range
from ..resilience import faults
from ..utils.timers import timeit
from .binary import (_assemble, _host_numpy, dtype_name, iter_local_blocks,
                     storage_dtype)
from .core import ParallelIODriver, maybe_unstack, metadata, pack_collection

__all__ = ["HDF5Driver", "HDF5File", "has_hdf5"]


def has_hdf5() -> bool:
    """Reference ``hdf5_has_parallel()`` analog (availability probe)."""
    try:
        import h5py  # noqa: F401
        return True
    except ImportError:
        return False


@dataclass(frozen=True)
class HDF5Driver(ParallelIODriver):
    """Reference ``PHDF5Driver`` analog (``hdf5.jl:16-25``).

    ``chunks=True`` stores datasets chunked by the writing pencil's local
    block shape — the analog of the reference's per-rank chunking option
    (``ext/PencilArraysHDF5Ext.jl:238-253``).
    """

    chunks: bool = False

    def open(self, filename: str, *, write: bool = False, read: bool = False,
             create: bool = False, append: bool = False,
             truncate: bool = False, comm=None) -> "HDF5File":
        if truncate:
            mode = "w"
        elif write or append or create:
            mode = "a"
        else:
            mode = "r"
        return HDF5File(filename, mode, chunks=self.chunks, comm=comm)


def _marker(dname: str) -> Optional[str]:
    """The ``pa_dtype`` attribute of a dtype HDF5 cannot hold natively."""
    return "bfloat16" if dname == "bfloat16" else None


class HDF5File:
    """An open HDF5 container of PencilArray datasets, shared by the
    ranks of ``comm``."""

    def __init__(self, filename: str, mode: str = "r", *,
                 chunks: bool = False, comm=None):
        if not has_hdf5():
            raise RuntimeError(
                "h5py is not available; use BinaryDriver (cf. the "
                "reference erroring when parallel HDF5 is absent, hdf5.jl "
                "docstrings)")
        import h5py

        self.chunks = chunks
        self.filename = os.fspath(filename)
        self.writable = mode != "r"
        self.comm = comm
        self._proc = process_index(comm)
        self._is_proc0 = self._proc == 0
        # Several-rank writes go through per-rank shard files + a
        # virtual-dataset master (see module docstring); reads always go
        # through the master, which resolves shard files transparently.
        self._multi = is_multiprocess(comm) and self.writable
        if self._multi:
            # locking=False throughout the collective mode: consistency
            # is carried by the flush + barrier discipline (never two
            # writers of one file), and HDF5's advisory locks would make a
            # peer's transient read of this rank's open shard fail.
            if self._is_proc0:
                with h5py.File(self.filename, "w" if mode == "w" else "a",
                               locking=False):
                    pass
            self._f = h5py.File(self._rank_filename(self._proc), mode,
                                locking=False)
            sync_global_devices("pa_h5_open", comm)
        else:
            self._f = h5py.File(self.filename, mode)

    def _rank_filename(self, proc: int) -> str:
        return f"{self.filename}.r{proc}"

    def close(self):
        self._f.close()
        if self._multi:
            # collective close: no rank proceeds (e.g. to re-open the
            # master read-only) until every writer released its shard file
            sync_global_devices("pa_h5_close", self.comm)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _master_ro(self):
        """Read-only handle on the master file (== ``self._f`` except in
        the several-rank write mode, whose ``_f`` is the shard file)."""
        import h5py

        if self._multi:
            return h5py.File(self.filename, "r", locking=False)
        return self._f

    def datasets(self):
        if self._multi:
            with self._master_ro() as mf:
                return sorted(mf.keys())
        return sorted(self._f.keys())

    # -- write ------------------------------------------------------------
    def write(self, name: str, x, *, block_observer=None) -> None:
        """``file[name] = x``: hyperslab writes of each rank's block
        (``ext/PencilArraysHDF5Ext.jl:113-118``), metadata as attributes
        (``ext:127-133``); a collective of ``comm``.  A tuple/list of
        same-pencil arrays is written as ONE dataset with a trailing
        component dim (collection-level I/O, ``ext:222-229``).

        ``block_observer(start, block)`` is called with this rank's
        logical-order host block (the checkpoint manager's checksum
        hook)."""
        if not self.writable:
            raise PermissionError("file not opened for writing")
        x, ncomp = pack_collection(x)
        from ..obs import io_op

        with io_op("io.write", "HDF5Driver", self.filename, name,
                   x.sizeof_global()), \
                timeit(x.pencil.timer, "write parallel"):
            if self._multi:
                self._write_multiproc(name, x, ncomp, block_observer)
            else:
                self._write_single(name, x, ncomp, block_observer)

    def _chunk_shape(self, x, shape):
        """Chunk by the MINIMUM nonempty block extent per dim, like the
        reference's Allreduce-min chunk dims (ext:238-253) — under uneven
        decompositions the first block is the largest, not the
        smallest."""
        pen = x.pencil
        mins = []
        for d, nd in enumerate(pen.size_global(LogicalOrder)):
            P = pen.proc_count(d)
            lens = [len(local_data_range(p, P, nd)) for p in range(P)]
            lens = [n for n in lens if n > 0] or [1]
            mins.append(min(lens))
        return tuple(min(c, s) for c, s in zip(
            tuple(mins) + tuple(x.extra_dims), shape))

    def _write_single(self, name: str, x, ncomp, block_observer) -> None:
        pen = x.pencil
        shape = pen.size_global(LogicalOrder) + tuple(x.extra_dims)
        dname = dtype_name(x.dtype)
        store_dt, marker = storage_dtype(dname), _marker(dname)
        chunk_shape = self._chunk_shape(x, shape) if self.chunks else None
        # reuse the dataset in place when compatible: HDF5 never reclaims
        # deleted-dataset space, so del+create would leak a full dataset
        # per checkpoint rewrite
        dset = self._f.get(name)
        if (dset is None or tuple(dset.shape) != shape
                or dset.dtype != store_dt or dset.chunks != chunk_shape):
            if dset is not None:
                del self._f[name]
            dset = self._f.create_dataset(name, shape=shape, dtype=store_dt,
                                          chunks=chunk_shape)

        def put(start, block):
            dset[tuple(slice(s, s + e)
                       for s, e in zip(start, block.shape))] = block

        for i, (start, block) in enumerate(iter_local_blocks(x)):
            faults.block_write_hook(i, start, block, block_observer, put,
                                    flush=self._f.flush)
            put(start, block)
        for k, v in metadata(x, collection=ncomp).items():
            dset.attrs[k] = json.dumps(v)
        if marker:
            dset.attrs["pa_dtype"] = json.dumps(marker)
        elif "pa_dtype" in dset.attrs:
            del dset.attrs["pa_dtype"]
        if not ncomp and "collection" in dset.attrs:
            del dset.attrs["collection"]

    def _write_multiproc(self, name: str, x, ncomp: int = None,
                         block_observer=None) -> None:
        """Collective several-rank write: shard files + VDS master.

        Each rank writes its block into its shard file under
        ``<name>/r<topology rank>`` (true-size, logical order); after the
        data barrier, rank 0 rebuilds the master's virtual dataset from
        pencil math alone and a final barrier orders the commit before
        any reader."""
        topo = x.pencil.topology
        dname = dtype_name(x.dtype)
        store_dt, marker = storage_dtype(dname), _marker(dname)
        grp = self._f.require_group(name)
        for i, (coords, start, block) in enumerate(
                iter_local_blocks(x, with_coords=True)):
            ds = f"r{topo.rank(coords)}"
            if ds in grp and (grp[ds].shape != block.shape
                              or grp[ds].dtype != store_dt):
                del grp[ds]  # shape changed; same-shape rewrites below
                # reuse the storage in place

            def put(_start, blk, ds=ds):
                # torn-injection path only: a partial-shape rank block
                # replaces the dataset outright (the master is never
                # rebuilt past the kill, so nothing reads it)
                if ds in grp:
                    del grp[ds]
                grp.create_dataset(ds, data=blk)

            faults.block_write_hook(i, start, block, block_observer, put,
                                    flush=self._f.flush)
            if ds in grp:
                grp[ds][...] = block
            else:
                # chunks=True: each rank block IS the reference's per-rank
                # chunk (ext:238-253); the virtual dataset itself cannot
                # be chunked, but its sources are
                grp.create_dataset(
                    ds, data=block,
                    chunks=(block.shape if self.chunks else None))
        self._f.flush()
        sync_global_devices("pa_h5_data", self.comm)
        if self._is_proc0:
            # retried entirely on rank 0 BETWEEN the barriers (peers are
            # parked at pa_h5_commit), so transient errors back off
            # without barrier desync; _build_master is idempotent
            from ..resilience.retry import RetryPolicy

            def _commit_master():
                faults.fire("io.flush_meta", path=self.filename)
                self._build_master(name, x, store_dt, marker, ncomp)

            RetryPolicy.from_env().call(
                _commit_master, label=f"build hdf5 master {self.filename}")
        sync_global_devices("pa_h5_commit", self.comm)

    def _owner(self, topo, rank: int) -> int:
        """The ``comm`` rank whose shard file holds topology rank
        ``rank``'s block."""
        if self.comm is None and topo.group is None:
            return rank
        return dist.get_group_rank(self.comm or dist.group.WORLD,
                                   topo.global_rank(rank))

    def _build_master(self, name: str, x, store_dt, marker,
                      ncomp: int = None):
        """Stitch the rank-block shard datasets into ONE virtual dataset
        in the master file (rank 0 only).  Source paths are relative
        (basename), so the file set is relocatable as a directory."""
        import h5py

        pen = x.pencil
        topo = pen.topology
        shape = pen.size_global(LogicalOrder) + tuple(x.extra_dims)
        layout = h5py.VirtualLayout(shape=shape, dtype=store_dt)
        for rank in range(len(topo)):
            rr = pen.range_local(topo.coords(rank), LogicalOrder)
            if any(len(r) == 0 for r in rr):
                continue  # empty ceil-rule block: nothing stored
            bshape = tuple(len(r) for r in rr) + tuple(x.extra_dims)
            src = h5py.VirtualSource(
                os.path.basename(self._rank_filename(self._owner(topo,
                                                                 rank))),
                f"{name}/r{rank}", shape=bshape)
            layout[tuple(slice(r.start, r.stop) for r in rr)] = src
        with h5py.File(self.filename, "a", locking=False) as mf:
            if name in mf:
                del mf[name]  # VDS metadata only; block data lives (and
                # is reused in place) in the shard files
            dset = mf.create_virtual_dataset(name, layout)
            for k, v in metadata(x, collection=ncomp).items():
                dset.attrs[k] = json.dumps(v)
            if marker:
                dset.attrs["pa_dtype"] = json.dumps(marker)

    # -- read -------------------------------------------------------------
    def read(self, name: str, pencil: Pencil,
             extra_dims: Optional[Tuple[int, ...]] = None):
        """Each rank reads its hyperslab and places it in its block —
        restartable under any decomposition.  Collection datasets come
        back as the original tuple."""
        from ..obs import io_op

        with io_op("io.read", "HDF5Driver", self.filename, name), \
                timeit(pencil.timer, "read parallel"):
            if self._multi:
                with self._master_ro() as mf:
                    return self._read_impl(mf[name], pencil, extra_dims)
            return self._read_impl(self._f[name], pencil, extra_dims)

    def _read_impl(self, dset, pencil: Pencil,
                   extra_dims: Optional[Tuple[int, ...]]):
        dims = tuple(dset.shape[: pencil.ndims])
        if dims != pencil.size_global(LogicalOrder):
            raise ValueError(
                f"dataset dims {dims} != pencil global dims "
                f"{pencil.size_global(LogicalOrder)}")
        if extra_dims is None:
            extra_dims = tuple(dset.shape[pencil.ndims:])
        marker = json.loads(dset.attrs["pa_dtype"]) \
            if "pa_dtype" in dset.attrs else None
        dname = marker or dset.dtype.name

        def block_reader(ranges, host):
            dset.read_direct(_host_numpy(host),
                             tuple(slice(r.start, r.stop) for r in ranges))

        ncomp = json.loads(dset.attrs["collection"]) \
            if "collection" in dset.attrs else None
        return maybe_unstack(
            _assemble(pencil, tuple(extra_dims), dname, block_reader),
            {"collection": ncomp})

    def attributes(self, name: str):
        """Stored decomposition metadata of a dataset."""
        if self._multi:
            with self._master_ro() as mf:
                return {k: json.loads(v) for k, v in mf[name].attrs.items()}
        return {k: json.loads(v) for k, v in self._f[name].attrs.items()}
