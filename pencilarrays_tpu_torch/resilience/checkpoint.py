"""Crash-safe checksummed checkpoints layered over the I/O drivers.

PyTorch counterpart of the JAX package's ``resilience/checkpoint.py``:
the same directory layout, ``MANIFEST.json`` and ``COMMIT`` protocol, so
each package restores (and verifies) the other's checkpoints.

A production job's dominant failure mode is *interruption*: a preempted
node, a worker SIGKILLed mid-checkpoint, a filesystem throwing transient
errors.  :class:`CheckpointManager` makes the
checkpoint-restart story trustworthy under exactly those failures:

* **Atomic commit** — each checkpoint is written into a temp directory
  (``.tmp-step-N``); only after every process's data, the per-block
  checksum manifest and their fsyncs land is the directory renamed to
  its final name and a ``COMMIT`` marker atomically published via
  ``os.replace``.  A crash at ANY earlier point leaves only garbage
  that :meth:`latest_valid` skips — never a half-checkpoint that parses.
* **End-to-end verification** — per-block CRC32C checksums are computed
  during the drivers' own ``iter_local_blocks`` streaming (the
  ``block_observer`` hook: no extra host copy of the array) and recorded
  in ``MANIFEST.json`` keyed by each block's logical-order global
  corner, so a reader under ANY process count or decomposition re-reads
  exactly those ranges and verifies them.  A mismatch raises
  :class:`CorruptCheckpointError` naming the dataset and block.
* **Retention GC** — ``keep=N`` bounds disk: after each successful
  commit the oldest committed checkpoints beyond N, stale temp
  directories and torn uncommitted directories are removed.

Layout of one checkpoint::

    <directory>/step-00000012/
        data.bin  data.bin.json    # (driver-dependent) the datasets
        MANIFEST.json              # per-dataset block checksums
        COMMIT                     # atomic commit marker (last to appear)

The manager is collective over ``comm`` (a ``torch.distributed`` process
group, the default one unless given): data writes go through the drivers'
collective protocols, each rank's block checksum is merged by rank 0
(``blocks.r<rank>.json`` scratch files), and every commit step is ordered
by the same named barriers the drivers use; with observability on, the
save, commit, GC, verification and restore journal the JAX package's
``ckpt.*`` records.  :meth:`CheckpointManager.save_async` runs a save on
the engine's host pool.  Two pieces wait for layers the port has not
ported (ROADMAP.md Queue 1, item 7): the mesh-wide election of
:meth:`CheckpointManager.common_latest_valid` (``cluster/``: without a
coordinator it is :meth:`~CheckpointManager.latest_valid`), and the
``corrupt`` mode of the ``ckpt.restore`` fault point (``guard/``); the
manifest's recovery ``epoch`` is 0 until ``cluster/`` exists.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import time
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

from . import faults
from . import checksum
from .checksum import ALGO, BlockChecksums, crc_of_array
from .errors import (CheckpointNotFoundError, CorruptCheckpointError,
                     ResilienceError)
from .fsutil import atomic_write_json as _atomic_write_json
from .fsutil import atomic_write_text, fsync_dir as _fsync_dir
from .retry import RetryPolicy, logger

__all__ = ["CheckpointManager", "Checkpoint"]

_LATER = "not ported yet: ROADMAP.md Queue 1, item 7 (control planes)"

MANIFEST_NAME = "MANIFEST.json"
COMMIT_NAME = "COMMIT"
MANIFEST_VERSION = "1.0"

_STEP_RE = re.compile(r"^step-(\d{8,})$")


def _data_filename(driver) -> str:
    """The datasets' container name inside a checkpoint directory."""
    name = type(driver).__name__
    return {"BinaryDriver": "data.bin", "HDF5Driver": "data.h5",
            "OrbaxDriver": "data"}.get(name, "data.bin")


def _supports_checksums(driver) -> bool:
    """Checksums need the logical-order ``block_observer`` streaming hook
    (binary discontiguous + HDF5); the Orbax driver stores padded device
    arrays through TensorStore, which carries its own integrity story."""
    return type(driver).__name__ in ("BinaryDriver", "HDF5Driver")


def _timed(observe, stats: dict):
    """``observe`` with its seconds added to ``stats["crc_s"]``."""
    def timed(start, block):
        t0 = time.perf_counter()
        observe(start, block)
        stats["crc_s"] += time.perf_counter() - t0
    return timed


class CheckpointManager:
    """Save/restore/latest/retention-GC over a checkpoint directory.

    Parameters
    ----------
    directory:
        Root holding one ``step-N`` subdirectory per checkpoint.
    driver:
        Any :class:`~pencilarrays_tpu.io.core.ParallelIODriver`
        (default :class:`~pencilarrays_tpu.io.BinaryDriver`).
    keep:
        Retain at most this many committed checkpoints (None: keep all).
    checksums:
        Record + verify per-block CRCs (default True; requires a driver
        with the ``block_observer`` hook).
    retry:
        :class:`RetryPolicy` for the driver opens and metadata flushes
        (default: :meth:`RetryPolicy.from_env`).
    comm:
        The process group whose ranks save and restore together (the
        default group unless given); every rank of it calls
        :meth:`save`.

    ``stats`` holds the seconds of the last :meth:`save` by stage:
    ``host_alloc_s``, ``k1_s`` and ``d2h_s`` (staging the blocks to the
    host), ``crc_s``,
    ``write_s``, ``fsync_s``, ``meta_s`` (the drivers' sidecar commit),
    ``commit_s`` (manifest, rename, ``COMMIT`` and GC) and ``total_s``,
    with the ``path`` the data took.
    """

    def __init__(self, directory: str, driver=None, *,
                 keep: Optional[int] = None, checksums: bool = True,
                 timer=None, retry: Optional[RetryPolicy] = None,
                 comm=None):
        from ..io import BinaryDriver

        self.directory = os.fspath(directory)
        self.driver = BinaryDriver() if driver is None else driver
        if checksums and not _supports_checksums(self.driver):
            raise ValueError(
                f"{type(self.driver).__name__} does not stream logical-order "
                f"blocks, so manifest checksums cannot be computed; pass "
                f"checksums=False (the driver's own storage integrity still "
                f"applies)")
        if keep is not None and keep < 1:
            raise ValueError("keep must be >= 1 (or None to keep all)")
        self.keep = keep
        self.checksums = checksums
        self.timer = timer
        self.retry = retry or RetryPolicy.from_env()
        self.comm = comm
        self.stats: Dict = {}
        self._data_name = _data_filename(self.driver)
        os.makedirs(self.directory, exist_ok=True)

    # -- paths / process helpers ------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step-{step:08d}")

    def _tmp_dir(self, step: int) -> str:
        return os.path.join(self.directory, f".tmp-step-{step:08d}")

    def _is_proc0(self) -> bool:
        from ..parallel.distributed import process_index

        return process_index(self.comm) == 0

    def _barrier(self, name: str) -> None:
        from ..parallel.distributed import sync_global_devices

        sync_global_devices(name, self.comm)

    def _scan(self) -> Dict[int, str]:
        """All final-named step directories (committed or torn)."""
        out = {}
        for entry in os.listdir(self.directory):
            m = _STEP_RE.match(entry)
            if m and os.path.isdir(os.path.join(self.directory, entry)):
                out[int(m.group(1))] = os.path.join(self.directory, entry)
        return out

    def is_committed(self, step: int) -> bool:
        return os.path.exists(os.path.join(self._step_dir(step), COMMIT_NAME))

    def steps(self) -> List[int]:
        """Committed steps, ascending (commit marker present; contents
        not yet verified — see :meth:`verify` / :meth:`latest_valid`)."""
        return sorted(s for s in self._scan() if self.is_committed(s))

    # -- save --------------------------------------------------------------
    def save(self, step: int, state: Mapping, *, chunks: bool = False) -> str:
        """Write ``state`` (dataset name -> PencilArray or tuple of
        same-pencil arrays) as checkpoint ``step``; returns the committed
        directory.  Crash-safe: until the final barrier the previous
        checkpoints are untouched and the new one is invisible."""
        from ..io import open_file
        from ..io.binary import dtype_name
        from ..io.core import pack_collection
        from ..parallel.pencil import LogicalOrder
        from ..utils.timers import timeit

        step = int(step)
        if step < 0:
            raise ValueError("step must be >= 0")
        if not state:
            raise ValueError("cannot checkpoint an empty state")
        if chunks and self.checksums:
            raise ValueError(
                "chunks=True stores memory-order rank blocks, which the "
                "logical-order manifest checksums cannot describe; pass "
                "checksums=False to combine them")
        if chunks and type(self.driver).__name__ != "BinaryDriver":
            raise ValueError(
                "chunks=True is a BinaryDriver layout option; "
                f"{type(self.driver).__name__} does not accept it")
        tmp, final = self._tmp_dir(step), self._step_dir(step)
        t_save0 = time.perf_counter()
        from .. import obs

        if obs.enabled():
            obs.counter("ckpt.saves").inc()
            obs.record_event("ckpt.save", step=step, status="begin",
                             dir=self.directory,
                             driver=type(self.driver).__name__,
                             datasets=sorted(state),
                             checksums=self.checksums)
        stats: Dict = {"crc_s": 0.0}
        self.stats = stats
        if self._is_proc0():
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
        self._barrier("pa_ckpt_tmp")

        timer = self.timer
        crcs = BlockChecksums() if self.checksums else None
        entries: Dict[str, dict] = {}
        with timeit(timer, "checkpoint save"):
            data_path = os.path.join(tmp, self._data_name)
            with open_file(self.driver, data_path, write=True, create=True,
                           truncate=True, retry=self.retry,
                           comm=self.comm) as f:
                for name, x in state.items():
                    view, ncomp = pack_collection(x)
                    entries[name] = {
                        "dtype": dtype_name(view.dtype),
                        "dims_logical": list(
                            view.pencil.size_global(LogicalOrder)),
                        "extra_dims": list(view.extra_dims),
                        "collection": ncomp,
                        "size_bytes": view.sizeof_global(),
                        "blocks": None,
                    }
                    if crcs is not None:
                        f.write(name, x, block_observer=_timed(
                            crcs.observer(name), stats))
                    elif chunks:
                        f.write(name, x, chunks=True)
                    else:
                        f.write(name, x)
            stats.update(getattr(f, "stats", {}))
            t_commit = time.perf_counter()

            from ..parallel.distributed import process_index

            if crcs is not None:
                _atomic_write_json(
                    os.path.join(tmp,
                                 f"blocks.r{process_index(self.comm)}.json"),
                    crcs.as_dict())
            self._barrier("pa_ckpt_blocks")

            if self._is_proc0():
                if crcs is not None:
                    merged: Dict[str, list] = {n: [] for n in entries}
                    for fname in sorted(os.listdir(tmp)):
                        if not re.match(r"^blocks\.r\d+\.json$", fname):
                            continue
                        with open(os.path.join(tmp, fname)) as bf:
                            for n, blocks in json.load(bf).items():
                                merged.setdefault(n, []).extend(blocks)
                        os.unlink(os.path.join(tmp, fname))
                    for n, blocks in merged.items():
                        entries[n]["blocks"] = sorted(
                            blocks, key=lambda b: tuple(b["start"]))
                manifest = {
                    "format": "pencilarrays-tpu-checkpoint",
                    "version": MANIFEST_VERSION,
                    "step": step,
                    # the JAX package's recovery-epoch stamp; 0 (never
                    # recovered) until the cluster layer is ported
                    "epoch": 0,
                    "driver": type(self.driver).__name__,
                    "data_file": self._data_name,
                    "algo": ALGO if self.checksums else None,
                    "datasets": entries,
                }
                self.retry.call(_atomic_write_json,
                                os.path.join(tmp, MANIFEST_NAME), manifest,
                                label="flush checkpoint manifest",
                                timer=timer)
            # the crash-before-commit injection point: a kill here leaves
            # a fully-written but never-visible temp directory
            faults.fire("ckpt.commit", step=step)
            if self._is_proc0():
                if os.path.exists(final):
                    # re-saving an existing step: move the old directory
                    # aside (into the GC'd temp namespace) instead of
                    # deleting it — a crash before the new COMMIT must
                    # not have destroyed the only copy
                    os.rename(final, f"{tmp}-replaced")
                os.rename(tmp, final)
                _fsync_dir(self.directory)
                # the one atomic commit point: COMMIT appears via replace
                atomic_write_text(os.path.join(final, COMMIT_NAME),
                                  f"step {step}\n")
                obs.record_event("ckpt.commit", step=step, dir=final)
            self._barrier("pa_ckpt_commit")
            if self._is_proc0():
                self._gc(current=step)
            self._barrier("pa_ckpt_done")
        t_end = time.perf_counter()
        stats.update(commit_s=t_end - t_commit, total_s=t_end - t_save0)
        if obs.enabled():
            obs.histogram("ckpt.save_seconds").observe(t_end - t_save0)
            obs.record_event("ckpt.save", step=step, status="committed",
                             seconds=t_end - t_save0)
        return final

    def save_async(self, step: int, state: Mapping, *,
                   chunks: bool = False, engine=None):
        """:meth:`save` on the engine's host pool
        (:meth:`~pencilarrays_tpu_torch.engine.Engine.host_task`),
        overlapped with whatever the dispatch queue runs next.  Returns a
        :class:`~pencilarrays_tpu_torch.engine.StepFuture` resolving to
        the committed directory; failures surface typed on the future.

        ``state`` is copied shallowly at submit; the tensors themselves
        are read when the save stages them, so no caller may write into
        them until the future resolves (``run_steps_async`` hands each
        save a state no later step writes).  Concurrent saves on one
        manager are the caller's to order (chain on the future, or use
        ``run_steps_async``).  On several ranks the save's barriers run
        off the consumer thread, so ``comm`` must be a
        :func:`~pencilarrays_tpu_torch.parallel.distributed.side_group`
        that no dispatch uses."""
        from ..engine import device_event, get_engine, wait_device

        self._check_async()
        eng = engine if engine is not None else get_engine()
        state = dict(state)
        # on the card the worker stages on its own stream: after the
        # device work queued so far on this thread's stream
        ready = device_event()

        def save():
            wait_device(ready)
            return self.save(step, state, chunks=chunks)

        return eng.host_task(save, label=f"ckpt.save:{step}")

    def _check_async(self) -> None:
        """Refuse a host-pool save whose barriers could interleave with
        the dispatches' collectives (:meth:`save_async`)."""
        from ..parallel.distributed import is_multiprocess, is_side_group

        if is_multiprocess(self.comm) and not is_side_group(self.comm):
            raise ValueError(
                "a save on the engine's host pool issues its barriers "
                "beside the dispatch queue's collectives: on several ranks "
                "build the manager with comm=distributed.side_group(...), "
                "made up front on every rank")

    def _recover_replaced(self) -> None:
        """A re-save of step N moves the old committed directory to
        ``.tmp-step-N-replaced`` before the new COMMIT lands; if the
        re-save crashed in that window, the replacement is torn and the
        moved-aside directory is the ONLY committed copy — put it back
        before anything could sweep it.  Best-effort and race-tolerant:
        ``os.rename`` is atomic, so under multi-process one process wins
        and the others' failures are ignored."""
        for entry in os.listdir(self.directory):
            m = re.match(r"^\.tmp-step-(\d{8,})-replaced$", entry)
            if not m:
                continue
            step = int(m.group(1))
            src = os.path.join(self.directory, entry)
            final = self._step_dir(step)
            if self.is_committed(step) \
                    or not os.path.exists(os.path.join(src, COMMIT_NAME)):
                continue  # replacement committed (src is garbage) or
                # src itself never was a committed checkpoint
            try:
                if os.path.exists(final):
                    shutil.rmtree(final)  # torn replacement wreckage
                os.rename(src, final)
                logger.warning(
                    "recovered checkpoint step %d from an interrupted "
                    "re-save (%s)", step, entry)
            except OSError:
                pass

    def _gc(self, current: Optional[int] = None) -> None:
        """Retention: drop oldest committed checkpoints beyond ``keep``,
        stale temp/replaced directories, and torn (uncommitted) step
        directories.  Runs only after the current step's COMMIT landed,
        so everything left in the temp namespace is garbage by then."""
        self._recover_replaced()
        removed = []
        for entry in os.listdir(self.directory):
            if entry.startswith(".tmp-"):
                removed.append(entry)
                shutil.rmtree(os.path.join(self.directory, entry),
                              ignore_errors=True)
        committed, torn = [], []
        for step, path in sorted(self._scan().items()):
            (committed if self.is_committed(step) else torn).append(path)
        for path in torn:
            if path != (self._step_dir(current) if current is not None
                        else None):
                logger.warning("GC removing torn checkpoint %s", path)
                removed.append(os.path.basename(path))
                shutil.rmtree(path, ignore_errors=True)
        if self.keep is not None:
            for path in committed[:-self.keep]:
                removed.append(os.path.basename(path))
                shutil.rmtree(path, ignore_errors=True)
        if removed:
            from .. import obs

            logger.info("checkpoint GC removed %s", sorted(removed))
            if obs.enabled():
                obs.counter("ckpt.gc_removed").inc(len(removed))
                obs.record_event("ckpt.gc", removed=sorted(removed),
                                 dir=self.directory)

    # -- verify / discover -------------------------------------------------
    def _load_manifest(self, step: int) -> dict:
        path = os.path.join(self._step_dir(step), MANIFEST_NAME)
        try:
            with open(path) as f:
                return json.load(f)
        except FileNotFoundError as e:
            raise CorruptCheckpointError(
                f"checkpoint step {step}: manifest missing ({path})",
                step=step, path=path) from e
        except (json.JSONDecodeError, UnicodeDecodeError, OSError) as e:
            raise CorruptCheckpointError(
                f"checkpoint step {step}: manifest unreadable ({e})",
                step=step, path=path) from e

    def verify(self, step: int) -> None:
        """Validate checkpoint ``step`` end-to-end: COMMIT marker,
        manifest, dataset presence, and (when recorded) every block's
        checksum.  Raises :class:`CorruptCheckpointError` naming the
        first failing dataset/block."""
        from .. import obs

        try:
            if not self.is_committed(step):
                raise CorruptCheckpointError(
                    f"checkpoint step {step} has no COMMIT marker "
                    f"(missing or torn write)", step=step,
                    path=self._step_dir(step))
            manifest = self._load_manifest(step)
            for name, ds in manifest["datasets"].items():
                self._verify_dataset(step, manifest, name, ds)
        except ResilienceError as e:
            if obs.enabled():
                obs.counter("ckpt.verify_failures").inc()
                obs.record_event("ckpt.verify", step=step, ok=False,
                                 error=str(e))
            raise
        if obs.enabled():
            obs.record_event("ckpt.verify", step=step, ok=True)

    def _checksum_blocks(self, step: int, manifest: dict, name: str,
                         ds: dict) -> Optional[List[dict]]:
        """Manifest blocks eligible for CRC verification, or ``None``
        when checksums are absent or the writer's algorithm is
        unavailable here.  A checkpoint is verified with the WRITER's
        algorithm; when this host cannot compute it, degrade to
        structural checks rather than falsely failing (or falsely
        passing) CRCs."""
        blocks = ds.get("blocks")
        algo = manifest.get("algo")
        if blocks is not None and not checksum.supported(algo):
            logger.warning(
                "checkpoint step %d: checksum algorithm %r unavailable on "
                "this host — skipping CRC verification of dataset %r",
                step, algo, name)
            return None
        return blocks

    def _verify_dataset(self, step: int, manifest: dict, name: str,
                        ds: dict) -> None:
        shape = tuple(ds["dims_logical"]) + tuple(ds["extra_dims"])
        blocks = self._checksum_blocks(step, manifest, name, ds)
        data_path = os.path.join(self._step_dir(step),
                                 manifest.get("data_file", self._data_name))
        if blocks is not None:
            covered = sum(int(np.prod(b["shape"], dtype=np.int64))
                          for b in blocks)
            if covered != int(np.prod(shape, dtype=np.int64)):
                raise CorruptCheckpointError(
                    f"checkpoint step {step} dataset {name!r}: manifest "
                    f"blocks cover {covered} elements of "
                    f"{int(np.prod(shape, dtype=np.int64))}",
                    step=step, dataset=name, path=data_path)
        if blocks is None:
            # checksums off (or algorithm unavailable): presence/metadata
            # check only — must NOT assume the discontiguous block-reader
            # layout (chunks-layout and Orbax checkpoints land here)
            self._check_dataset_present(step, data_path, name)
            return
        self._verify_block_list(step, manifest, name, ds, blocks)

    def _verify_block_list(self, step: int, manifest: dict, name: str,
                           ds: dict, blocks: List[dict]) -> None:
        """Checksum-verify ``blocks`` (any subset of the manifest's
        block list) against the stored data."""
        algo = manifest.get("algo")
        data_path = os.path.join(self._step_dir(step),
                                 manifest.get("data_file", self._data_name))
        try:
            with self._open_block_reader(manifest, data_path, name,
                                         ds) as read_block:
                for i, b in enumerate(blocks):
                    start, bshape = tuple(b["start"]), tuple(b["shape"])
                    try:
                        got = crc_of_array(read_block(start, bshape), algo)
                    except (OSError, ValueError, IndexError) as e:
                        raise CorruptCheckpointError(
                            f"checkpoint step {step} dataset {name!r} "
                            f"block {i} (start={start}, shape={bshape}): "
                            f"unreadable ({type(e).__name__}: {e})",
                            step=step, dataset=name, block=i,
                            path=data_path) from e
                    if got != b["crc"]:
                        raise CorruptCheckpointError(
                            f"checkpoint step {step} dataset {name!r} "
                            f"block {i} (start={start}, shape={bshape}): "
                            f"checksum mismatch ({manifest['algo']} "
                            f"{got:#010x} != recorded {b['crc']:#010x}) — "
                            f"the data file is corrupt",
                            step=step, dataset=name, block=i,
                            path=data_path)
        except ResilienceError:
            raise
        except (OSError, ValueError, KeyError) as e:
            # opening the container / locating the dataset failed: a
            # truncated data file, an unloadable sidecar, a dataset the
            # (possibly corrupted) metadata no longer names
            raise CorruptCheckpointError(
                f"checkpoint step {step} dataset {name!r}: data unreadable "
                f"({type(e).__name__}: {e})",
                step=step, dataset=name, path=data_path) from e

    def _verify_dataset_local(self, step: int, manifest: dict, name: str,
                              ds: dict, pencil) -> None:
        """Cross-decomposition restore verification: map the WRITER's
        global-corner block manifest onto the READER pencil's local
        extents and checksum-verify exactly the intersecting blocks.

        The manifest keys blocks by logical-order global corner — a
        deliberately decomposition-independent address — so a reformed
        mesh (different process count, different decomposition, even
        ``world == 1``) can restore a checkpoint written under a
        topology that no longer exists, verifying only the bytes this
        process is about to trust instead of re-reading the whole
        global array on every rank.  Degrades exactly like
        :meth:`_verify_dataset` when checksums are absent or the
        writer's algorithm is unavailable here."""
        blocks = self._checksum_blocks(step, manifest, name, ds)
        if blocks is None:
            data_path = os.path.join(
                self._step_dir(step),
                manifest.get("data_file", self._data_name))
            self._check_dataset_present(step, data_path, name)
            return
        self._verify_block_list(step, manifest, name, ds,
                                self._local_blocks(pencil, ds, blocks))

    @staticmethod
    def _local_blocks(pencil, ds: dict, blocks: List[dict]) -> List[dict]:
        """The manifest blocks whose logical-order global extents
        intersect THIS rank's block of ``pencil``."""
        from ..parallel.pencil import LogicalOrder

        local = pencil.range_local(pencil.topology.coords_local,
                                   LogicalOrder)
        return CheckpointManager._blocks_intersecting(
            [local], len(ds["dims_logical"]), blocks)

    @staticmethod
    def _blocks_intersecting(local_ranges, nd: int,
                             blocks: List[dict]) -> List[dict]:
        """Pure intersection: manifest blocks (logical-order global
        ``start``/``shape``, the first ``nd`` dims being the spatial
        ones) overlapping any of ``local_ranges`` (tuples of ``range``
        per spatial dim)."""
        out = []
        for b in blocks:
            start, bshape = b["start"], b["shape"]
            for rngs in local_ranges:
                if all(start[d] < rngs[d].stop
                       and start[d] + bshape[d] > rngs[d].start
                       for d in range(nd)):
                    out.append(b)
                    break
        return out

    def _check_dataset_present(self, step: int, data_path: str,
                               name: str) -> None:
        """Driver-agnostic structural check: the container opens and
        names the dataset (the checksums-off validation level)."""
        try:
            f = self.driver.open(data_path, read=True)
        except ResilienceError:
            raise
        except (OSError, ValueError, KeyError, RuntimeError) as e:
            raise CorruptCheckpointError(
                f"checkpoint step {step} dataset {name!r}: container "
                f"unreadable ({type(e).__name__}: {e})",
                step=step, dataset=name, path=data_path) from e
        try:
            if hasattr(f, "dataset_meta"):       # binary: sidecar entry
                f.dataset_meta(name)
            else:                                # hdf5 / orbax: name list
                names = f.datasets() if callable(f.datasets) else [
                    d["name"] for d in f.datasets]
                if name not in names:
                    raise KeyError(name)
        except (OSError, ValueError, KeyError) as e:
            raise CorruptCheckpointError(
                f"checkpoint step {step} dataset {name!r}: missing from "
                f"the data container ({type(e).__name__}: {e})",
                step=step, dataset=name, path=data_path) from e
        finally:
            f.close()

    def _open_block_reader(self, manifest: dict, data_path: str, name: str,
                           ds: dict):
        """Context manager yielding ``read_block(start, shape)`` over the
        dataset's logical-order global index space."""
        from contextlib import contextmanager

        shape = tuple(ds["dims_logical"]) + tuple(ds["extra_dims"])
        driver_name = manifest.get("driver", type(self.driver).__name__)
        if driver_name == "HDF5Driver":
            import h5py

            @contextmanager
            def h5_reader():
                with h5py.File(data_path, "r", locking=False) as hf:
                    dset = hf[name]
                    if tuple(dset.shape) != shape:
                        raise CorruptCheckpointError(
                            f"dataset {name!r}: stored shape "
                            f"{tuple(dset.shape)} != manifest {shape}",
                            dataset=name, path=data_path)

                    def read_block(start, bshape):
                        sl = tuple(slice(s, s + e)
                                   for s, e in zip(start, bshape))
                        return np.asarray(dset[sl])

                    yield read_block

            return h5_reader()

        # binary driver: sidecar gives the dataset offset; blocks are
        # strided views of the discontiguous logical-order region
        from ..io.binary import storage_dtype

        @contextmanager
        def bin_reader():
            f = self.driver.open(data_path, read=True)
            try:
                d = f.dataset_meta(name)
                if d.get("layout") != "discontiguous":
                    raise CorruptCheckpointError(
                        f"dataset {name!r}: layout {d.get('layout')!r} does "
                        f"not support manifest verification",
                        dataset=name, path=data_path)
                if tuple(d["dims_logical"]) != tuple(ds["dims_logical"]):
                    raise CorruptCheckpointError(
                        f"dataset {name!r}: sidecar dims "
                        f"{d['dims_logical']} != manifest "
                        f"{ds['dims_logical']}",
                        dataset=name, path=data_path)
                mm = np.memmap(data_path, dtype=storage_dtype(d["dtype"]),
                               mode="r", offset=d["offset_bytes"],
                               shape=shape)

                def read_block(start, bshape):
                    sl = tuple(slice(s, s + e)
                               for s, e in zip(start, bshape))
                    return mm[sl]

                yield read_block
                del mm
            finally:
                f.close()

        return bin_reader()

    def latest_valid(self) -> Optional[int]:
        """Newest step that is committed AND passes verification;
        uncommitted, torn or checksum-failing checkpoints are skipped
        with a logged warning.  ``None`` when nothing valid exists.
        Also recovers a committed step parked in the ``-replaced``
        namespace by a re-save that crashed before its new COMMIT.

        This is a *per-process* answer — on a multi-process mesh where
        each host verifies its own storage, use
        :meth:`common_latest_valid` so every rank restores the SAME
        step."""
        self._recover_replaced()
        for step in sorted(self._scan(), reverse=True):
            if not self.is_committed(step):
                logger.warning(
                    "checkpoint step %d skipped: no COMMIT marker", step)
                continue
            try:
                self.verify(step)
            except ResilienceError as e:
                logger.warning("checkpoint step %d skipped: %s", step, e)
                continue
            return step
        return None

    def valid_steps(self) -> List[int]:
        """EVERY committed step that passes verification, ascending —
        the full restorable set this process can vouch for (the input
        to the mesh-wide checkpoint election)."""
        self._recover_replaced()
        out = []
        for step in sorted(self._scan()):
            if not self.is_committed(step):
                continue
            try:
                self.verify(step)
            except ResilienceError as e:
                logger.warning("checkpoint step %d skipped: %s", step, e)
                continue
            out.append(step)
        return out

    def common_latest_valid(self, *, coordinator=None) -> Optional[int]:
        """Newest step that is :meth:`latest_valid`-grade on **every**
        rank — the JAX package's agreed-checkpoint election, which
        publishes each rank's :meth:`valid_steps` through the cluster
        layer's coordinator.  Without a coordinator it is
        :meth:`latest_valid` exactly; the election itself waits for
        ``cluster/``."""
        if coordinator is not None:
            raise NotImplementedError(
                f"the checkpoint election is {_LATER}; it waits for "
                f"cluster/")
        return self.latest_valid()

    # -- restore -----------------------------------------------------------
    def restore(self, step: Optional[int] = None,
                *, verify: Optional[bool] = None) -> "Checkpoint":
        """Open checkpoint ``step`` (default: :meth:`latest_valid`, through
        :meth:`common_latest_valid`) for reading.  ``verify`` (default: the manager's
        ``checksums`` setting) validates the requested datasets against
        the manifest before any bytes are trusted.  When the step comes
        from :meth:`latest_valid` it was fully verified moments ago, so
        the per-read verification defaults OFF for that path (pass
        ``verify=True`` to force it anyway)."""
        if step is None:
            step = self.common_latest_valid()
            if step is None:
                raise CheckpointNotFoundError(
                    f"no valid committed checkpoint under "
                    f"{self.directory!r}")
            if verify is None:
                verify = False  # just verified by latest_valid()
        step = int(step)
        if not self.is_committed(step):
            raise CheckpointNotFoundError(
                f"checkpoint step {step} is not committed under "
                f"{self.directory!r}")
        manifest = self._load_manifest(step)
        return Checkpoint(self, step, manifest,
                          verify=self.checksums if verify is None else verify)


class Checkpoint:
    """A committed checkpoint opened for restore."""

    def __init__(self, manager: CheckpointManager, step: int, manifest: dict,
                 *, verify: bool):
        self.manager = manager
        self.step = step
        self.manifest = manifest
        self.verify = verify
        self.path = manager._step_dir(step)

    @property
    def datasets(self) -> List[str]:
        return sorted(self.manifest["datasets"])

    def read(self, name: str, pencil, extra_dims: Optional[Tuple] = None,
             *, verify=None):
        """Read dataset ``name`` into ``pencil`` (any decomposition or
        number of ranks — the drivers' restart contract); a collective of
        the manager's ``comm``.  With
        verification on, every manifest block is checksum-validated
        first; corruption raises :class:`CorruptCheckpointError` instead
        of returning garbage.  ``verify="local"`` is the
        cross-decomposition restore mode: only the writer's manifest
        blocks that intersect THIS rank's local extents of
        ``pencil`` are verified — what an elastic reformation onto a
        smaller mesh wants, where re-verifying the whole global array
        on every surviving rank would multiply restore latency."""
        from ..io import open_file
        from ..utils.timers import timeit

        mf = self.manifest
        if name not in mf["datasets"]:
            raise KeyError(
                f"dataset {name!r} not in checkpoint step {self.step} "
                f"(has {self.datasets})")
        do_verify = self.verify if verify is None else verify
        from .. import obs

        t0 = time.perf_counter()
        with timeit(self.manager.timer, "checkpoint restore"):
            if do_verify == "local":
                self.manager._verify_dataset_local(
                    self.step, mf, name, mf["datasets"][name], pencil)
            elif do_verify:
                self.manager._verify_dataset(self.step, mf, name,
                                             mf["datasets"][name])
            data_path = os.path.join(
                self.path, mf.get("data_file", self.manager._data_name))
            with open_file(self.manager.driver, data_path, read=True,
                           retry=self.manager.retry,
                           comm=self.manager.comm) as f:
                out = f.read(name, pencil, extra_dims)
            if faults.armed("ckpt.restore"):
                # the post-read SDC drill point: data verified on disk,
                # then corrupted in flight (the JAX package's element) —
                # what guarded_step and the hop probes exist to catch
                act = faults.fire("ckpt.restore", step=self.step,
                                  dataset=name)
                if act == "torn":   # cannot tear a read: treat as kill
                    faults.kill_now()
                if act == "corrupt":
                    from ..guard import integrity as _gi

                    _gi.corrupt_eager(out,
                                      faults.hit_count("ckpt.restore") - 1)
        if obs.enabled():
            dt = time.perf_counter() - t0
            obs.counter("ckpt.restores").inc()
            obs.histogram("ckpt.restore_seconds").observe(dt)
            obs.record_event("ckpt.restore", step=self.step, dataset=name,
                             seconds=dt, verified=do_verify)
        return out

    def read_state(self, pencil, names: Optional[List[str]] = None) -> Dict:
        """Restore several datasets (default: all) onto one pencil."""
        return {name: self.read(name, pencil)
                for name in (names or self.datasets)}
