"""Orbax-layout checkpoint driver over TensorStore — the JAX package's
``io/orbax_driver.py``, whose files it writes and reads.

The JAX package's second driver stores each dataset as an Orbax
``StandardCheckpointer`` item: a TensorStore OCDBT database holding one
zarr (v2) array per key, the item's ``_METADATA`` tree and
``_CHECKPOINT_METADATA``, and a ``<name>.meta.json`` beside it with the
decomposition metadata (``dims_logical``, ``dims_padded_memory``, the
permutation, the extra dims, the component count of a collection).  Orbax
exists only in JAX's world, but its storage layer is TensorStore, which
imports on its own: this driver writes that layout with TensorStore alone,
so Orbax restores the port's files and the port reads Orbax's.  The
dependency is optional (gated import), as in the JAX package:
:func:`has_orbax` says whether ``tensorstore`` imports.

Each dataset is stored as its global array in the pencil's memory order
(the JAX package's padded sharded array; the port writes it unpadded and
records that shape, which the JAX reader slices to the logical dims
alike).  Several ranks: the topology's rank 0 gathers the blocks
(``gather``) and writes the item, the others wait at a barrier of
``comm``; every rank reads the item and
keeps its own block (``PencilArray.from_global``).  Decomposition
independent, as every driver: a dataset restores into any pencil of its
dims.  ``async_write=True`` issues TensorStore's writes and returns; the
metadata commits once :meth:`OrbaxFile.wait_until_finished` (or
``close``) has seen every write durable.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..parallel.arrays import PencilArray
from ..parallel.distributed import process_index, sync_global_devices
from ..parallel.gather import gather
from ..parallel.pencil import LogicalOrder, Pencil
from ..resilience import faults
from ..resilience.retry import RetryPolicy
from .binary import dtype_name
from .core import ParallelIODriver, metadata, pack_collection

__all__ = ["OrbaxDriver", "OrbaxFile", "has_orbax"]

# what Orbax's StandardCheckpointHandler writes around an item's arrays
_HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
            "StandardCheckpointHandler")


def has_orbax() -> bool:
    """Whether the Orbax layout can be written and read here: TensorStore
    imports (the JAX package asks for ``orbax.checkpoint``, which the port
    does not need)."""
    try:
        import tensorstore  # noqa: F401
        return True
    except ImportError:
        return False


@dataclass(frozen=True)
class OrbaxDriver(ParallelIODriver):
    """Reference ``PHDF5Driver`` analog (``hdf5.jl:16-25``), the JAX
    package's ``OrbaxDriver``.  ``async_write=True`` overlaps the write
    with the caller's work; ``close``/``wait_until_finished`` block until
    storage is durable."""

    async_write: bool = False

    def open(self, filename: str, *, write: bool = False, read: bool = False,
             create: bool = False, append: bool = False,
             truncate: bool = False, comm=None) -> "OrbaxFile":
        writable = write or create or truncate or append
        return OrbaxFile(filename, write=writable,
                         async_write=self.async_write and writable,
                         comm=comm)


def _ts_dtype(name: str):
    import tensorstore as ts

    return ts.bfloat16 if name == "bfloat16" else ts.dtype(name)


def _zarr_dtype(name: str) -> str:
    return "bfloat16" if name == "bfloat16" else np.dtype(name).str


def _spec(item: str, key: str) -> dict:
    return {"driver": "zarr",
            "kvstore": {"driver": "ocdbt", "base": f"file://{item}",
                        "path": f"{key}/"}}


class OrbaxFile:
    """A checkpoint directory holding named PencilArray datasets, one
    Orbax item each."""

    def __init__(self, path: str, *, write: bool, async_write: bool = False,
                 comm=None):
        if not has_orbax():
            raise RuntimeError(
                "tensorstore is not available; use BinaryDriver (cf. "
                "reference PencilIO falling back when parallel HDF5 is "
                "absent)")
        self.path = os.path.abspath(path)
        self.writable = write
        self.async_write = async_write
        self.comm = comm
        if write and process_index(comm) == 0:
            os.makedirs(self.path, exist_ok=True)
        if write:
            sync_global_devices("orbax_open", comm)
        # async mode: metadata is withheld until every write is durable,
        # so a failed background write never leaves a meta file
        # advertising a missing checkpoint
        self._pending = []      # (name, meta, item, futures)
        self._closed = False

    def _item_dir(self, name: str) -> str:
        return os.path.join(self.path, name)

    def _meta_path(self, name: str) -> str:
        return os.path.join(self.path, name + ".meta.json")

    def write(self, name: str, x) -> None:
        """``x`` may be a tuple/list of same-pencil arrays — stored as ONE
        item with a key per component (collection-level I/O); :meth:`read`
        returns the tuple back."""
        from ..obs import io_op

        x, ncomp = pack_collection(x)
        with io_op("io.write", "OrbaxDriver", self._item_dir(name), name,
                   x.sizeof_global(), async_write=self.async_write):
            self._write_impl(name, x, ncomp)

    def _write_impl(self, name: str, x, ncomp) -> None:
        if not self.writable:
            raise PermissionError("checkpoint not opened for writing")
        self.wait_until_finished()
        comps = list(x.components) if ncomp else [x]
        keys = [f"c{i}" for i in range(len(comps))] if ncomp else ["data"]
        name_dt = dtype_name(x.dtype)
        perm = x.pencil.permutation
        mem = tuple(perm.axes()) if not perm.is_identity() else None
        nd = len(x.pencil.size_global())
        # every rank takes part in the gathers; rank 0 writes
        arrays = []
        for c in comps:
            full = gather(c)
            if full is not None:
                if mem is not None:
                    full = np.transpose(full, mem + tuple(
                        range(nd, full.ndim)))
                full = np.ascontiguousarray(full)
                if name_dt == "bfloat16":
                    # gather widens bf16 to f32 (exactly): back to its bits
                    full = torch.from_numpy(full).to(torch.bfloat16).view(
                        torch.int16).numpy().view(np.uint16)
                arrays.append(full)
        if arrays:                      # the rank the gathers landed on
            item = self._item_dir(name)
            if os.path.exists(item):
                shutil.rmtree(item)
            # the old metadata must not outlive the data it described
            if os.path.exists(self._meta_path(name)):
                os.unlink(self._meta_path(name))
            futures = self._write_item(item, keys, arrays, name_dt)
            meta = {
                "dtype": name_dt,
                "dims_logical": list(x.pencil.size_global(LogicalOrder)),
                "dims_padded_memory": list(arrays[0].shape),
                "metadata": metadata(x, collection=ncomp),
            }
            self._pending.append((name, meta, item, futures))
            if not self.async_write:
                self.wait_until_finished()
        if not self.async_write:
            sync_global_devices(f"orbax_write_{name}", self.comm)

    def _write_item(self, item: str, keys, arrays, name_dt: str) -> list:
        import tensorstore as ts

        os.makedirs(item)
        futures = []
        for key, arr in zip(keys, arrays):
            t = ts.open(dict(_spec(item, key), create=True, metadata={
                "shape": list(arr.shape), "chunks": list(arr.shape),
                "dtype": _zarr_dtype(name_dt),
                "compressor": {"id": "zstd", "level": 1},
                "fill_value": None, "order": "C"}),
                dtype=_ts_dtype(name_dt)).result()
            src = arr.view(ts.bfloat16.numpy_dtype) \
                if name_dt == "bfloat16" else arr
            futures.append(t.write(src))
        tree = {f"('{k}',)": {
            "key_metadata": [{"key": k, "key_type": 2}],
            "value_metadata": {"value_type": "np.ndarray",
                               "skip_deserialize": False,
                               "write_shape": list(a.shape)}}
            for k, a in zip(keys, arrays)}
        self._json(os.path.join(item, "_METADATA"), {
            "tree_metadata": tree, "use_ocdbt": True, "use_zarr3": False,
            "store_array_data_equal_to_fill_value": True,
            "custom_metadata": None})
        return futures

    @staticmethod
    def _json(path: str, blob: dict) -> None:
        from ..resilience.fsutil import atomic_write_json

        atomic_write_json(path, blob)

    def _publish_meta(self, name: str, meta: dict, item: str) -> None:
        """Durably publish a dataset's metadata — the commit point of a
        write, so it passes the ``io.flush_meta`` fault point, is retried
        on transient errors, and lands via atomic replace (Orbax's
        ``_CHECKPOINT_METADATA`` first, then the dataset's meta file)."""
        now = time.time_ns()
        self._json(os.path.join(item, "_CHECKPOINT_METADATA"), {
            "item_handlers": _HANDLER, "metrics": {},
            "performance_metrics": {}, "init_timestamp_nsecs": now,
            "commit_timestamp_nsecs": now, "custom_metadata": {}})

        def _flush():
            faults.fire("io.flush_meta", path=self._meta_path(name))
            self._json(self._meta_path(name), meta)

        RetryPolicy.from_env().call(_flush,
                                    label=f"flush orbax meta {name}")

    def read(self, name: str, pencil: Pencil,
             extra_dims: Optional[Tuple[int, ...]] = None):
        """Collection datasets come back as the original tuple."""
        import tensorstore as ts

        self.wait_until_finished()
        with open(self._meta_path(name)) as f:
            meta = json.load(f)
        dims = tuple(meta["dims_logical"])
        if dims != pencil.size_global(LogicalOrder):
            raise ValueError(
                f"dataset dims {dims} != pencil dims "
                f"{pencil.size_global(LogicalOrder)}")
        if extra_dims is None:
            extra_dims = tuple(meta["metadata"]["extra_dims"])
        saved_perm = meta["metadata"]["permutation"]
        saved_pad = tuple(meta["dims_padded_memory"])
        ncomp = meta["metadata"].get("collection")
        name_dt = meta["dtype"]
        n = len(dims)
        # a legacy collection (one stacked array under "data") carries the
        # trailing component dim in its saved shape
        stored_extra = meta["metadata"]["extra_dims"]
        legacy = bool(ncomp) and len(saved_pad) == n + len(stored_extra)
        keys = ["data"] if legacy or not ncomp else \
            [f"c{i}" for i in range(ncomp)]
        item = self._item_dir(name)

        def reconstruct(key):
            arr = ts.open(_spec(item, key), open=True).result().read() \
                .result()
            if name_dt == "bfloat16":
                arr = arr.view(np.uint16)
            ne = arr.ndim - n
            if saved_perm:
                arr = np.transpose(arr, tuple(int(i) for i in np.argsort(
                    saved_perm)) + tuple(range(n, n + ne)))
            arr = np.ascontiguousarray(arr[tuple(slice(0, d)
                                                 for d in dims)])
            t = torch.from_numpy(arr)
            if name_dt == "bfloat16":
                t = t.view(torch.bfloat16)
            return PencilArray.from_global(pencil, t)

        if legacy:
            return reconstruct("data").unstack()
        if ncomp:
            return tuple(reconstruct(k) for k in keys)
        return reconstruct("data")

    def datasets(self):
        return sorted(f[: -len(".meta.json")] for f in os.listdir(self.path)
                      if f.endswith(".meta.json"))

    def wait_until_finished(self):
        """Block until every issued write is durable, then publish the
        withheld metadata.  A failed write drops the pending entries, so a
        later wait/close cannot publish metadata for data that never
        became durable."""
        pending, self._pending = self._pending, []
        for name, meta, item, futures in pending:
            for fut in futures:
                fut.result()
            self._publish_meta(name, meta, item)

    def close(self):
        self.wait_until_finished()
        if self.async_write:
            sync_global_devices("orbax_close", self.comm)
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
