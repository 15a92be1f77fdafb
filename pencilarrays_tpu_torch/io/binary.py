"""Raw-binary parallel I/O driver with JSON sidecar metadata.

PyTorch counterpart of the JAX package's ``io/binary.py`` (reference
``src/PencilIO/mpi_io.jl``): a raw binary data file plus a ``<file>.json``
sidecar recording, per dataset, the dtype, logical dims, endianness and
byte offset (``mpi_io.jl:100-113, 194-211``).  The format is the JAX
package's, so each package reads the other's files.

Two on-disk layouts, as in the reference:

* **discontiguous** (default): the dataset occupies the file in *global
  logical order*, each rank's block scattered to its strided positions —
  the reference's ``MPI.Types.create_subarray`` + collective ``write_all``
  (``mpi_io.jl:335-380``).  Files are re-readable under **any** number of
  ranks or decomposition (``mpi_io.jl:159-167``).
* **chunks**: each block's true-size memory-order data contiguous, blocks
  in rank order (``mpi_io.jl:382-424``) — tied to the writing
  configuration, but the chunk map in the sidecar still allows a correct
  re-read under a different one.

The JAX package is single-controller and walks every addressable shard of
its process; here every rank writes and reads its own block into the one
shared file, as the reference's MPI-IO does, and rank 0 alone writes the
sidecar, between the same named barriers.  A block moves between its
padded memory-order place on the device and its logical-order place in the
file through one K1 permute (``ops/permute.py``: the true-size prefix, so
the padding never travels) into a staging tensor and one copy to or from
pinned host memory; the native library (``io/native.py``) then writes or
reads the file's strided runs.  On the CPU the plain permute serves.  A
block with trailing extra dims, or a collection, is staged one component
at a time, so a write never holds a second full copy of the array on the
device.

Append mode adds datasets to an existing file at the synchronized end
offset (``mpi_io.jl:70-75``); metadata-less read is supported by passing an
explicit offset and dtype, like the reference's raw read path
(``mpi_io.jl:265-278``).
"""

from __future__ import annotations

import functools
import json
import math
import os
import sys
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops import permute as k1
from ..parallel.arrays import PencilArray, _fwd_axes, _inv_axes, as_torch_dtype
from ..parallel.distributed import (is_multiprocess, process_index,
                                    sync_global_devices)
from ..parallel.pencil import LogicalOrder, MemoryOrder, Pencil
from ..resilience import faults
from ..resilience.errors import CorruptSidecarError
from ..resilience.retry import RetryPolicy
from ..utils.timers import timeit
from .core import CollectionView, ParallelIODriver, maybe_unstack, metadata
from .core import pack_collection
from . import native

__all__ = ["BinaryDriver", "BinaryFile", "iter_local_blocks", "dtype_name"]

FORMAT_VERSION = "1.0"


def _endianness() -> str:
    return sys.byteorder


def dtype_name(dtype) -> str:
    """The NumPy name of a torch dtype, as the sidecar records it
    (``"bfloat16"`` for the type NumPy holds only through ``ml_dtypes``)."""
    return "bfloat16" if dtype == torch.bfloat16 else \
        str(dtype).split(".")[-1]


def storage_dtype(name: str) -> np.dtype:
    """The NumPy dtype whose bytes hold a dataset of dtype ``name``:
    bfloat16 travels as its 16-bit pattern."""
    return np.dtype(np.uint16) if name == "bfloat16" else np.dtype(name)


def _host_numpy(t: torch.Tensor) -> np.ndarray:
    """A NumPy view of a contiguous CPU tensor (bfloat16 as uint16)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _tick(stats: Optional[dict], key: str, t0: float,
          device: Optional[torch.device] = None) -> float:
    """Add the seconds since ``t0`` to ``stats[key]`` and return the time;
    a stage on a CUDA ``device`` is waited for first (the calling thread's
    current stream, where the stage was launched: not the device, whose
    other streams may be busy with later work), so its seconds are the
    device's."""
    if device is not None and device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
    t1 = time.perf_counter()
    if stats is not None:
        stats[key] = stats.get(key, 0.0) + (t1 - t0)
    return t1


def _host_empty(shape, dtype: torch.dtype, device: torch.device):
    """A host buffer for a block: pinned when it meets a CUDA device."""
    return torch.empty(tuple(shape), dtype=dtype,
                       pin_memory=device.type == "cuda")


def _parts(x) -> Tuple[List[PencilArray], bool]:
    """The arrays staged one at a time, and whether their host blocks stack
    along a trailing dim: a collection's components, a PencilArray's
    components along its last extra dim, or the array itself."""
    if isinstance(x, CollectionView):
        return list(x.components), True
    if x.ndims_extra:
        return list(x.unstack()), True
    return [x], False


def _stage(part: PencilArray, order, dst: torch.Tensor, clock) -> None:
    """This rank's true-size block of ``part`` in ``order`` into the host
    tensor ``dst``: one K1 permute of the padded block's prefix into a
    staging tensor (none where the prefix is already the block, in
    order), then one copy to the host."""
    pen = part.pencil
    mem = pen.size_local(pen.topology.coords_local, MemoryOrder)
    prefix = part.data[tuple(slice(0, n) for n in mem)]
    axes = (_inv_axes(pen, part.ndims_extra) if order is LogicalOrder
            else tuple(range(prefix.dim())))
    t0 = time.perf_counter()
    if axes == tuple(range(prefix.dim())) and prefix.is_contiguous():
        staged = prefix
    else:
        staged = k1.permute(prefix, axes)
        t0 = clock("k1_s", t0)
    dst.copy_(staged)
    clock("d2h_s", t0)


def iter_local_blocks(x, order=LogicalOrder, with_coords: bool = False,
                      stats: Optional[dict] = None):
    """Yield THIS rank's block (at most one; none where the block is
    empty): with ``order=LogicalOrder`` (default) ``(start, block)``,
    where ``start`` is the logical-order global corner and ``block`` the
    true-size logical-order data as a host NumPy array; with
    ``order=MemoryOrder`` ``(coords, block)`` with the block left in
    memory order.  ``with_coords=True`` prepends the topology coords to
    the LogicalOrder tuples (``(coords, start, block)``).  The JAX
    package's ``iter_local_blocks``, shared by every driver's write path;
    ``stats`` collects the seconds of the host block's allocation
    (``host_alloc_s``: pinned memory, on the card), the K1 permutes
    (``k1_s``) and the copies to the host (``d2h_s``).

    A :class:`~pencilarrays_tpu_torch.io.core.CollectionView` (and a
    PencilArray with extra dims) is staged one component at a time into
    the host block, stacked along its trailing dim."""
    pen = x.pencil
    coords = pen.topology.coords_local
    rr = pen.range_local(coords, LogicalOrder)
    if any(len(r) == 0 for r in rr):
        return
    parts, stacked = _parts(x)
    device = parts[0].device
    true = (tuple(len(r) for r in rr) if order is LogicalOrder
            else pen.size_local(coords, MemoryOrder))
    t0 = time.perf_counter()
    host = _host_empty(true + tuple(x.extra_dims), x.dtype, device)
    clock = functools.partial(_tick, stats, device=device)
    clock("host_alloc_s", t0)
    for i, part in enumerate(parts):
        _stage(part, order, host[..., i] if stacked else host, clock)
    block = _host_numpy(host)
    if order is MemoryOrder:
        yield coords, block
        return
    start = tuple(r.start for r in rr) + (0,) * x.ndims_extra
    yield (coords, start, block) if with_coords else (start, block)


def _assemble(pencil: Pencil, extra_dims: Tuple[int, ...], dtype,
              block_reader: Callable, stats: Optional[dict] = None
              ) -> PencilArray:
    """This rank's PencilArray of ``pencil``: ``block_reader(ranges,
    host)`` fills the host tensor ``host`` with the true-size logical-order
    block of this rank's logical ``ranges``; one copy moves it to the
    device and one K1 permute writes it, logical order to memory order,
    into the padded block, whose padding stays zero."""
    topo = pencil.topology
    extra_dims = tuple(extra_dims)
    dtype = as_torch_dtype(dtype)
    out = torch.zeros(pencil.padded_size_local(MemoryOrder) + extra_dims,
                      dtype=dtype, device=topo.device)
    rr = pencil.range_local(topo.coords_local, LogicalOrder)
    if all(len(r) for r in rr):
        clock = functools.partial(_tick, stats, device=topo.device)
        t0 = time.perf_counter()
        host = _host_empty(tuple(len(r) for r in rr) + extra_dims, dtype,
                           topo.device)
        t0 = clock("host_alloc_s", t0)
        block_reader(rr, host)
        t0 = clock("read_s", t0)
        _place(out, pencil, len(extra_dims), host,
               tuple(range(len(rr) + len(extra_dims))),
               tuple(range(len(r)) for r in rr), clock, t0)
    return PencilArray(pencil, out, extra_dims)


def _place(out: torch.Tensor, pencil: Pencil, nx: int, host: torch.Tensor,
           to_logical: Tuple[int, ...], where, clock, t0: float) -> None:
    """Copy ``host`` to the device and permute it into ``out``, the
    padded memory-order block of ``pencil``: ``host.permute(to_logical)``
    is logical order, and it lands at the local logical ranges ``where``."""
    dev = host.to(out.device)
    t0 = clock("h2d_s", t0)
    fwd = _fwd_axes(pencil, nx)
    logical = out.permute(_inv_axes(pencil, nx))
    dst = logical[tuple(slice(r.start, r.stop) for r in where)].permute(fwd)
    k1.permute(dev, tuple(to_logical[i] for i in fwd), out=dst)
    clock("k1_s", t0)


@dataclass(frozen=True)
class BinaryDriver(ParallelIODriver):
    """Reference ``MPIIODriver`` analog (``mpi_io.jl:23-27``).

    The reference's ``sequential``/``uniqueopen`` options are MPI-IO
    open-mode hints with no analog here (block writes are independent
    positioned writes).  ``uniquify_names=True`` is a convenience beyond
    the reference: repeated dataset names get ``(n)`` suffixes instead of
    replacing the existing dataset.

    ``reuse_regions`` (default True) bounds file growth under checkpoint
    rotation: a same-name, same-size rewrite ping-pongs between TWO file
    regions — the new bytes land in the dataset's spare region (never
    the region the current sidecar points at) and the sidecar flush
    swaps them.  A crash mid-rewrite therefore leaves the previous
    checkpoint fully intact (old sidecar -> old region, untouched),
    unlike a plain in-place store; steady-state cost is 2x the dataset
    size instead of monotonic growth.  ``reuse_regions=False`` restores
    pure append-only layout.
    """

    uniquify_names: bool = False
    reuse_regions: bool = True

    def open(self, filename: str, *, write: bool = False, read: bool = False,
             create: bool = False, append: bool = False,
             truncate: bool = False, comm=None) -> "BinaryFile":
        return BinaryFile(filename, write=write, read=read, create=create,
                          append=append, truncate=truncate,
                          uniquify_names=self.uniquify_names,
                          reuse_regions=self.reuse_regions, comm=comm)


def _fresh_meta() -> Dict:
    return {"driver": "BinaryDriver", "version": FORMAT_VERSION,
            "endianness": _endianness(), "datasets": []}


class BinaryFile:
    """An open dataset container (reference ``MPIFile``,
    ``mpi_io.jl:41-76``), shared by the ranks of ``comm``.

    ``stats`` accumulates, over this file's writes and reads, the seconds
    of each stage (``host_alloc_s``, ``k1_s``, ``d2h_s``, ``h2d_s``,
    ``write_s``, ``read_s``, ``fsync_s``, ``meta_s``) and the ``path`` the
    data took:
    ``"native_mt(<threads>)"`` or ``"memmap"``."""

    def __init__(self, filename: str, *, write=False, read=False,
                 create=False, append=False, truncate=False,
                 uniquify_names=False, reuse_regions=True, comm=None):
        self.uniquify_names = uniquify_names
        self.reuse_regions = reuse_regions
        self.filename = os.fspath(filename)
        self.meta_filename = self.filename + ".json"
        self.writable = write or append or create or truncate
        self.comm = comm
        self.stats: Dict = {}
        self._is_proc0 = process_index(comm) == 0
        multiproc = is_multiprocess(comm)
        filename = self.filename
        # append (like Julia open flags, where append implies create) and
        # any write mode create a missing file; truncate always resets.
        if self.writable and multiproc:
            # COLLECTIVE open (like MPI_File_open): rank 0 creates or
            # resets the file and flushes a fresh sidecar BEFORE the
            # barrier; peers only look at the filesystem after it, so they
            # can never observe a half-created file or mid-dump sidecar.
            if self._is_proc0 and (truncate or not os.path.exists(filename)):
                with open(filename, "wb"):
                    pass
                self._meta = _fresh_meta()
                self._flush_meta()
            sync_global_devices("pa_io_open", comm)
            if not os.path.exists(filename):
                raise FileNotFoundError(filename)
            self._meta = self._load_meta()
        elif truncate or (not os.path.exists(filename) and self.writable):
            with open(filename, "wb"):
                pass
            self._meta = _fresh_meta()
            self._flush_meta()
        elif os.path.exists(filename):
            self._meta = self._load_meta()
        else:
            raise FileNotFoundError(filename)
        # Base offset: dataset offsets must be identical on every rank.
        # Under several ranks, file size is a RACING shared variable (a
        # peer's truncate/pwrite can land between barrier exit and a
        # getsize call), so the base comes from the sidecar metadata only
        # — the analog of the reference synchronizing the shared file
        # position across ranks (``mpi_io.jl:70-75``).  One-rank opens
        # may additionally append after sidecar-less raw content, where
        # getsize is authoritative.
        meta_end = max(
            (d["offset_bytes"] + d["size_bytes"]
             for d in self._meta["datasets"]), default=0)
        if multiproc:
            self._base_offset = meta_end
        else:
            self._base_offset = max(meta_end, (
                os.path.getsize(filename) if os.path.exists(filename)
                else 0))
        self._closed = False

    # -- metadata ---------------------------------------------------------
    def _load_meta(self) -> Dict:
        if os.path.exists(self.meta_filename):
            try:
                with open(self.meta_filename) as f:
                    return json.load(f)
            except (json.JSONDecodeError, UnicodeDecodeError) as e:
                raise CorruptSidecarError(
                    f"corrupt sidecar {self.meta_filename!r} ({e}): the "
                    f"data file cannot be interpreted without it.  Recover "
                    f"from the last committed checkpoint "
                    f"(resilience.CheckpointManager.latest_valid()), or use "
                    f"read_raw(offset=...) if the layout is known.",
                    path=self.meta_filename) from e
        return _fresh_meta()

    def _flush_meta(self):
        # transient filesystem errors at the commit point back off and
        # retry rather than abort a checkpoint whose data already landed
        RetryPolicy.from_env().call(
            self._flush_meta_once,
            label=f"flush sidecar {self.meta_filename}")

    def _flush_meta_once(self):
        faults.fire("io.flush_meta", path=self.meta_filename)
        # atomic fsync'd replace: a crash mid-flush must never corrupt the
        # sidecar (it is the commit point of every write)
        from ..resilience.fsutil import atomic_write_json

        atomic_write_json(self.meta_filename, self._meta)

    @property
    def datasets(self) -> List[Dict]:
        return self._meta["datasets"]

    def dataset_meta(self, name: str) -> Dict:
        for d in self._meta["datasets"]:
            if d["name"] == name:
                return d
        raise KeyError(f"dataset {name!r} not in {self.meta_filename}")

    def _end_offset(self) -> int:
        end = self._base_offset
        for d in self._meta["datasets"]:
            end = max(end, d["offset_bytes"] + d["size_bytes"])
            spare = d.get("spare_offset")
            if spare is not None:
                end = max(end, spare + d["size_bytes"])
        return end

    def close(self):
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- write ------------------------------------------------------------
    def write(self, name: str, x, *, chunks: bool = False,
              block_observer=None) -> None:
        """``file[name] = x`` of the reference (``mpi_io.jl:170-189``); a
        collective of ``comm``.  ``x`` may be a tuple/list of same-pencil
        arrays — written as ONE dataset with a trailing component dim
        (collection-level I/O); :meth:`read` returns the tuple back.

        ``block_observer(start, block)`` is called with this rank's
        logical-order host block as it is written (the checkpoint
        manager's checksum hook — the block is already the write path's
        host copy, so observing adds no copy).  Discontiguous layout
        only."""
        if not self.writable:
            raise PermissionError("file not opened for writing")
        if block_observer is not None and chunks:
            raise ValueError(
                "block_observer streams logical-order blocks; the chunks "
                "layout stores memory-order rank blocks")
        x, ncomp = pack_collection(x)
        if self.uniquify_names:
            base, n = name, 1
            existing = {d["name"] for d in self._meta["datasets"]}
            while name in existing:
                n += 1
                name = f"{base}({n})"
        from ..obs import io_op

        with io_op("io.write", "BinaryDriver", self.filename, name,
                   x.sizeof_global(),
                   layout="chunks" if chunks else "discontiguous"):
            with timeit(x.pencil.timer, "write parallel"):
                self._write_dataset(name, x, chunks, ncomp, block_observer)

    def _write_dataset(self, name: str, x, chunks: bool,
                       ncomp: int = None, block_observer=None):
        # Rewriting an existing dataset of identical size ping-pongs
        # between two regions: the new bytes go to the SPARE region (the
        # previous version's old slot, or a fresh one on the first
        # rewrite), never the region the current sidecar references, so
        # a crash before the sidecar flush leaves the prior checkpoint
        # fully readable.  Deterministic across ranks: name, size and
        # spare offsets all derive from the (synchronized) sidecar +
        # pencil math.
        prev = None if not self.reuse_regions else next(
            (d for d in self._meta["datasets"] if d["name"] == name), None)
        spare = None
        if prev is not None and prev["size_bytes"] == x.sizeof_global():
            spare = prev["offset_bytes"]  # becomes the next spare
            offset = prev.get("spare_offset")
            if offset is None:
                offset = self._end_offset()
        else:
            offset = self._end_offset()
        dname = dtype_name(x.dtype)
        entry = {
            "name": name,
            "offset_bytes": offset,
            "dtype": dname,
            "endianness": _endianness(),
            "dims_logical": list(x.pencil.size_global(LogicalOrder)),
            "layout": "chunks" if chunks else "discontiguous",
            "size_bytes": x.sizeof_global(),
            "metadata": metadata(x, collection=ncomp),
        }
        if spare is not None:
            entry["spare_offset"] = spare
        itemsize = storage_dtype(dname).itemsize
        if chunks:
            entry["chunk_map"] = self._write_chunks(x, offset, itemsize)
        else:
            self._write_discontiguous(x, offset, dname, block_observer)
        self._meta["datasets"] = [
            d for d in self._meta["datasets"] if d["name"] != name
        ] + [entry]
        # Commit ordering (what makes the ping-pong rewrite actually
        # crash-consistent): (1) every rank's data bytes reach disk
        # (fsync is per-inode, so one fd suffices per rank), (2) a
        # barrier proves ALL ranks finished step 1, (3) only then does
        # rank 0 durably flush the sidecar that references the new
        # region, (4) a final barrier orders the flush before any peer
        # reads.  Flushing before (2) would let a crash commit a sidecar
        # pointing at a peer's half-written bytes.
        t0 = time.perf_counter()
        with open(self.filename, "rb+") as f:
            os.fsync(f.fileno())
        t0 = _tick(self.stats, "fsync_s", t0)
        sync_global_devices("pa_io_data", self.comm)
        if self._is_proc0:
            self._flush_meta()
        sync_global_devices("pa_io_write", self.comm)
        _tick(self.stats, "meta_s", t0)

    def _write_discontiguous(self, x, offset: int, dname: str,
                             block_observer=None):
        shape = x.pencil.size_global(LogicalOrder) + tuple(x.extra_dims)
        sdt = storage_dtype(dname)
        total = offset + math.prod(shape) * sdt.itemsize
        if self._is_proc0:
            # extend (never shrink: a reused rewrite offset may sit before
            # later datasets) so short datasets are well-formed
            with open(self.filename, "r+b") as f:
                f.truncate(max(total, os.path.getsize(self.filename)))
        # Order rank 0's extension before any peer's data write: memmap
        # r+ extends a too-short file by writing at the last byte, which
        # on a shared FS is unordered w.r.t. other ranks' writes and can
        # zero bytes a peer already wrote.
        sync_global_devices("pa_io_truncate", self.comm)
        # Each rank writes exactly its own block into the shared file —
        # the collective write_all of mpi_io.jl:335-380.  The block passes
        # the ``io.write_block`` fault point and the optional
        # block_observer checksum hook before its bytes are written.
        if native.available():
            nthreads = native.default_threads()
            self.stats["path"] = f"native_mt({nthreads})"

            def put(start, block):
                native.scatter_write(self.filename, offset, block, shape,
                                     start, nthreads=nthreads)
            flush = None
        else:
            self.stats["path"] = "memmap"
            mm = np.memmap(self.filename, dtype=sdt, mode="r+",
                           offset=offset, shape=shape)

            def put(start, block):
                mm[tuple(slice(s, s + e)
                         for s, e in zip(start, block.shape))] = block
            flush = mm.flush
        for i, (start, block) in enumerate(
                iter_local_blocks(x, stats=self.stats)):
            faults.block_write_hook(i, start, block, block_observer, put,
                                    flush=flush, path=self.filename)
            t0 = time.perf_counter()
            put(start, block)
            if flush is not None:
                flush()
            _tick(self.stats, "write_s", t0)

    def _write_chunks(self, x, offset: int, itemsize: int) -> List[Dict]:
        pen = x.pencil
        topo = pen.topology
        # The chunk map is pure pencil math — every rank derives the
        # identical table, so no coordination is needed for offsets
        # (mpi_io.jl:382-424 rank-order layout).
        chunk_map = []
        pos = offset
        for rank in range(len(topo)):
            coords = topo.coords(rank)
            rr = pen.range_local(coords, LogicalOrder)
            shape_mem = pen.size_local(coords, MemoryOrder) + tuple(
                x.extra_dims)
            chunk_map.append({
                "rank": rank,
                "offset_bytes": pos,
                "dims_memory": list(shape_mem),
                "ranges_logical": [[r.start, r.stop] for r in rr],
            })
            pos += math.prod(shape_mem) * itemsize
        if self._is_proc0:
            with open(self.filename, "r+b") as f:
                f.truncate(max(pos, os.path.getsize(self.filename)))
        sync_global_devices("pa_io_truncate", self.comm)
        # each rank writes its own chunk
        self.stats["path"] = "file"
        with open(self.filename, "r+b") as f:
            for i, (coords, block) in enumerate(
                    iter_local_blocks(x, MemoryOrder, stats=self.stats)):
                rank = topo.rank(coords)

                def put(_coords, blk, rank=rank):
                    f.seek(chunk_map[rank]["offset_bytes"])
                    f.write(np.ascontiguousarray(blk).data)

                faults.block_write_hook(i, coords, block, None, put,
                                        flush=f.flush, path=self.filename)
                t0 = time.perf_counter()
                put(coords, block)
                f.flush()
                _tick(self.stats, "write_s", t0)
        return chunk_map

    # -- read -------------------------------------------------------------
    def read(self, name: str, pencil: Pencil,
             extra_dims: Tuple[int, ...] = None):
        """Read a dataset into a (possibly different) pencil configuration
        (reference ``read!``, ``mpi_io.jl:239-263``): dtype/dims/endianness
        are verified against the sidecar (``mpi_io.jl:293-324``); each
        rank reads its own block.  Collection datasets come back as the
        original tuple."""
        from ..obs import io_op

        with io_op("io.read", "BinaryDriver", self.filename, name), \
                timeit(pencil.timer, "read parallel"):
            return self._read_impl(name, pencil, extra_dims)

    def _read_impl(self, name: str, pencil: Pencil,
                   extra_dims: Tuple[int, ...] = None):
        d = self.dataset_meta(name)
        if d["endianness"] != _endianness():
            raise ValueError(
                f"endianness mismatch: file {d['endianness']}, host "
                f"{_endianness()}")
        dims = tuple(d["dims_logical"])
        if dims != pencil.size_global(LogicalOrder):
            raise ValueError(
                f"dataset dims {dims} != pencil global dims "
                f"{pencil.size_global(LogicalOrder)}")
        if extra_dims is None:
            extra_dims = tuple(d["metadata"]["extra_dims"])
        extra_dims = tuple(extra_dims)
        if d["layout"] == "discontiguous":
            out = _assemble(pencil, extra_dims, d["dtype"],
                            self._block_reader(d["offset_bytes"],
                                               d["dtype"],
                                               dims + extra_dims),
                            self.stats)
        else:
            out = self._read_chunks(d, pencil, extra_dims)
        return maybe_unstack(out, d["metadata"])

    def _block_reader(self, offset: int, dname: str, full_shape):
        """``read(ranges, host)``: the logical block at ``ranges`` of the
        discontiguous dataset at ``offset`` into the host tensor."""
        sdt = storage_dtype(dname)
        nx = len(full_shape)
        if native.available():
            self.stats["path"] = f"native_mt({native.default_threads()})"

            def read(ranges, host):
                start = tuple(r.start for r in ranges)
                start += (0,) * (nx - len(start))
                native.gather_read(self.filename, offset, sdt, full_shape,
                                   start, host.shape, out=_host_numpy(host))
            return read
        self.stats["path"] = "memmap"

        def read(ranges, host):
            mm = np.memmap(self.filename, dtype=sdt, mode="r",
                           offset=offset, shape=tuple(full_shape))
            np.copyto(_host_numpy(host),
                      mm[tuple(slice(r.start, r.stop) for r in ranges)])
            del mm
        return read

    def _read_chunks(self, d: Dict, pencil: Pencil,
                     extra_dims: Tuple[int, ...]) -> PencilArray:
        """Rebuild this rank's block from the chunks its logical ranges
        meet — works under ANY target decomposition (slower than the
        matching-layout fast path the reference also distinguishes).
        Each piece is read in the writer's memory order and K1 permutes it
        into place."""
        topo = pencil.topology
        dtype = as_torch_dtype(d["dtype"])
        sdt = storage_dtype(d["dtype"])
        out = torch.zeros(pencil.padded_size_local(MemoryOrder) + extra_dims,
                          dtype=dtype, device=topo.device)
        rr = pencil.range_local(topo.coords_local, LogicalOrder)
        n = len(rr)
        perm = d["metadata"]["permutation"]
        wperm = tuple(perm) if perm else tuple(range(n))   # mem i = logical
        to_logical = tuple(int(i) for i in np.argsort(wperm)) + tuple(
            range(n, n + len(extra_dims)))
        clock = functools.partial(_tick, self.stats, device=topo.device)
        self.stats["path"] = "file"
        for ch in d["chunk_map"]:
            cut = [(max(a, r.start), min(b, r.stop))
                   for (a, b), r in zip(ch["ranges_logical"], rr)]
            if any(hi <= lo for lo, hi in cut):
                continue
            shape_mem = tuple(ch["dims_memory"])
            start_l = [lo - a for (lo, _), (a, _) in
                       zip(cut, ch["ranges_logical"])]
            ext_l = [hi - lo for lo, hi in cut]
            start_m = tuple(start_l[p] for p in wperm) + (0,) * len(
                extra_dims)
            ext_m = tuple(ext_l[p] for p in wperm) + extra_dims
            t0 = time.perf_counter()
            host = _host_empty(ext_m, dtype, topo.device)
            t0 = clock("host_alloc_s", t0)
            self._read_region(ch["offset_bytes"], sdt, shape_mem, start_m,
                              _host_numpy(host))
            t0 = clock("read_s", t0)
            _place(out, pencil, len(extra_dims), host, to_logical,
                   tuple(range(lo - r.start, hi - r.start)
                         for (lo, hi), r in zip(cut, rr)), clock, t0)
        return PencilArray(pencil, out, extra_dims)

    def _read_region(self, offset, sdt, shape, start, out: np.ndarray):
        if native.available():
            native.gather_read(self.filename, offset, sdt, shape, start,
                               out.shape, out=out)
            return
        mm = np.memmap(self.filename, dtype=sdt, mode="r", offset=offset,
                       shape=tuple(shape))
        np.copyto(out, mm[tuple(slice(s, s + e)
                                for s, e in zip(start, out.shape))])
        del mm

    def read_raw(self, pencil: Pencil, dtype, *, offset: int = 0,
                 extra_dims: Tuple[int, ...] = ()) -> PencilArray:
        """Metadata-less read (reference ``mpi_io.jl:265-278``): caller
        supplies dtype/offset; data assumed discontiguous logical order.
        Each rank reads its own block."""
        dname = dtype_name(as_torch_dtype(dtype))
        dims = pencil.size_global(LogicalOrder) + tuple(extra_dims)
        return _assemble(pencil, tuple(extra_dims), dname,
                         self._block_reader(offset, dname, dims), self.stats)
