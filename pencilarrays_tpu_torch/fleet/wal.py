"""Durable router WAL — the fleet front-end's crash-survivable memory.

:class:`~pencilarrays_tpu_torch.fleet.router.FleetRouter` holds every
accepted ticket in an in-memory ``_Pending`` map; before this module a
router SIGKILL silently lost every in-flight request — the one place
the fleet's exactly-once contract still leaked.  The WAL closes it:
every admission, placement and completion is appended *before* the
corresponding wire write, so a restarted router can replay the log
(:meth:`~pencilarrays_tpu_torch.fleet.router.FleetRouter.recover`), re-park
every unresolved ticket and resolve each exactly once.

Durability discipline (the obs journal's, hardened one notch):

* records append to an ``O_APPEND`` fd — concurrent writers interleave
  whole lines, never tear them;
* every append is flushed AND fsync'd — the WAL is the router's
  commit point, so "acked" must mean "on the platter" (the obs journal
  fsyncs only critical events; a WAL has no non-critical records);
* each record is **CRC-framed**: the line is ``<crc32:08x> <json>``,
  so replay distinguishes a torn tail (or foreign wreckage) from a
  committed record instead of trusting whatever parses;
* the reader is torn-tail tolerant: an unframed/corrupt line is
  counted and skipped, never raised — a crash mid-append loses at most
  the record being written, which by write-AHEAD ordering had not been
  acted on yet;
* rotation mirrors the obs journal: when the active segment crosses
  ``PENCILARRAYS_TPU_FLEET_WAL_MAX_MB`` (checked at a record
  boundary), it rotates to ``wal.<k>.jsonl`` and a fresh
  ``wal.jsonl`` opens; replay consumes rotated segments in order.

Record grammar (one JSON object per line, ``op``-discriminated):

========  ==================================================  =========
op        fields                                              meaning
========  ==================================================  =========
admit     ``tid``, ``req`` (the full wire-encoded request)    accepted
place     ``tid``, ``mesh``, ``rebinds``                      bound
complete  ``tid``, ``outcome`` (``ok``/error type name)       resolved
========  ==================================================  =========

The ``admit`` record embeds the verbatim
:func:`~pencilarrays_tpu_torch.fleet.wire.encode_request` blob — replay
reconstructs the payload from the same codec the wire uses, so there
is exactly ONE serialized request form in the system.

:func:`replay` folds a record stream into the recovered state:
completions are **deduped by ticket id** (a duplicate ``complete`` —
two meshes answering one re-bound ticket — counts, never
double-resolves), and replaying an already-replayed log is a no-op by
construction (the fold is pure).
"""

from __future__ import annotations

import glob
import json
import os
import re
import threading
import zlib
from typing import Dict, List, Optional, Set, Tuple

from ..resilience.fsutil import fsync_dir

__all__ = ["RouterWAL", "read_wal", "replay"]

ACTIVE = "wal.jsonl"
_SEGMENT_RE = re.compile(r"^wal\.(\d+)\.jsonl$")


def _frame(rec: dict) -> str:
    payload = json.dumps(rec, separators=(",", ":"))
    return f"{zlib.crc32(payload.encode('utf-8')):08x} {payload}\n"


def _unframe(line: str) -> Optional[dict]:
    """One framed line back to its record; None for a torn tail, a
    CRC mismatch, or foreign wreckage (the reader skips, never
    raises)."""
    line = line.rstrip("\n")
    if len(line) < 10 or line[8] != " ":
        return None
    crc, payload = line[:8], line[9:]
    try:
        if int(crc, 16) != zlib.crc32(payload.encode("utf-8")):
            return None
        rec = json.loads(payload)
    except ValueError:
        return None
    return rec if isinstance(rec, dict) else None


class RouterWAL:
    """Append side of the log (one per router).  Thread-safe: the
    router appends from the submit path and the pump thread at once."""

    def __init__(self, wal_dir: str, *,
                 max_bytes: Optional[int] = None):
        self.dir = os.fspath(wal_dir)
        # explicit cap wins; None defers to the env knob at append
        # time (late-arming, like the obs journal's rotation cap)
        self._max_bytes = max_bytes
        self._lock = threading.Lock()
        self._file = None
        os.makedirs(self.dir, exist_ok=True)
        fsync_dir(self.dir)

    def _cap(self) -> Optional[int]:
        if self._max_bytes is not None:
            return self._max_bytes
        from ..engine import config as _rtconfig

        return _rtconfig.current().fleet_wal_max_bytes

    def _open_locked(self):
        if self._file is None:
            # "a" = O_APPEND: whole-line atomicity for the two
            # appending threads
            self._file = open(os.path.join(self.dir, ACTIVE), "a",
                              buffering=1)
        return self._file

    def _rotate_locked(self) -> None:
        """The obs journal's rotation, verbatim in spirit: at a record
        boundary the active segment renames to the next free
        ``wal.<k>.jsonl`` and a fresh ``wal.jsonl`` opens.  A failed
        rename keeps appending to the old file — rotation is a
        bound on segment size, never a correctness gate."""
        base = os.path.join(self.dir, ACTIVE)
        try:
            self._file.close()
        except OSError:
            pass
        self._file = None
        k = 1
        while os.path.exists(os.path.join(self.dir, f"wal.{k}.jsonl")):
            k += 1
        try:
            os.replace(base, os.path.join(self.dir, f"wal.{k}.jsonl"))
            fsync_dir(self.dir)
        except OSError:
            pass
        self._file = open(base, "a", buffering=1)

    def append(self, rec: dict) -> None:
        """Durably append one record: write + flush + fsync, then
        rotate if the segment crossed the cap.  Raises ``OSError`` on
        a dead disk — the router treats an unappendable WAL as a
        failed admission, never a silent un-logged ticket."""
        line = _frame(rec)
        with self._lock:
            f = self._open_locked()
            f.write(line)
            f.flush()
            os.fsync(f.fileno())
            cap = self._cap()
            if cap is not None:
                try:
                    if f.tell() >= cap:
                        self._rotate_locked()
                except (OSError, ValueError):
                    pass

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                try:
                    self._file.close()
                except OSError:
                    pass
                self._file = None


def read_wal(wal_dir: str) -> Tuple[List[dict], int]:
    """Every committed record under ``wal_dir`` in append order —
    rotated segments first (numeric order), then the active file.
    Returns ``(records, skipped)`` where ``skipped`` counts torn or
    corrupt lines (forensics, not failures)."""
    d = os.fspath(wal_dir)
    paths = []
    for p in glob.glob(os.path.join(d, "wal.*.jsonl")):
        m = _SEGMENT_RE.match(os.path.basename(p))
        if m:
            paths.append((int(m.group(1)), p))
    paths = [p for _, p in sorted(paths)]
    active = os.path.join(d, ACTIVE)
    if os.path.exists(active):
        paths.append(active)
    records: List[dict] = []
    skipped = 0
    for path in paths:
        try:
            with open(path) as f:
                lines = f.readlines()
        except OSError:
            continue
        for line in lines:
            if not line.strip():
                continue
            rec = _unframe(line)
            if rec is None:
                skipped += 1
                continue
            records.append(rec)
    return records, skipped


def replay(records: List[dict]) -> dict:
    """Fold a record stream into recovered router state::

        {"pending":    {tid: {"req": <wire blob>, "mesh": last-bound,
                              "rebinds": n}},
         "resolved":   {tid, ...},      # completed at least once
         "duplicates": n}               # extra completes, deduped

    Pure and idempotent: the same log folds to the same state however
    many times it replays.  A ``complete`` for an unknown tid (its
    ``admit`` sat in the torn tail) still lands in ``resolved`` — the
    ticket provably finished, so recovery must not resurrect it."""
    pending: Dict[str, dict] = {}
    resolved: Set[str] = set()
    duplicates = 0
    for rec in records:
        op = rec.get("op")
        tid = rec.get("tid")
        if not isinstance(tid, str):
            continue
        if op == "admit":
            if tid not in resolved:
                pending[tid] = {"req": rec.get("req"), "mesh": None,
                                "rebinds": 0}
        elif op == "place":
            p = pending.get(tid)
            if p is not None:
                p["mesh"] = rec.get("mesh")
                p["rebinds"] = int(rec.get("rebinds", 0))
        elif op == "complete":
            if tid in resolved:
                duplicates += 1
                continue
            resolved.add(tid)
            pending.pop(tid, None)
    return {"pending": pending, "resolved": resolved,
            "duplicates": duplicates}
