"""The event flight recorder: an append-only JSONL journal (a copy of the
JAX package's ``obs/events.py``: the same ``SCHEMA_VERSION``, the same
record layout and file names, so either package's ``lint_journal`` reads
the other's journal).

Every record is one JSON line with the run id, the process index (the
rank, ``cluster.rank``), wall and monotonic timestamps, a per-process
sequence number and the correlation keys (``obs/correlate.py``,
``obs/requestflow.py``).  Durability: the journal is opened ``O_APPEND``
(concurrent writers interleave whole lines), every record is flushed,
and critical records (checkpoint commits, faults, retries, run
boundaries) are also ``fsync``'d; ``PENCILARRAYS_TPU_OBS_FSYNC`` =
``always | critical | never`` tunes this.

Enablement: ``PENCILARRAYS_TPU_OBS`` unset/empty/``0`` = off (the
default; :func:`record_event` is then one cached probe).  ``1`` / ``on``
/ ``true`` = on, journal under ``PENCILARRAYS_TPU_OBS_DIR`` (default
``./pa_obs``); any other value is itself the journal directory.
``PENCILARRAYS_TPU_OBS_MAX_MB`` rotates the journal to
``journal.r<p>.<k>.jsonl`` segments.
"""

from __future__ import annotations

import atexit
import json
import os
import sys
import threading
import time
import uuid
from contextlib import contextmanager
from typing import List, Optional

from ..resilience.fsutil import fsync_dir

__all__ = [
    "ENV_VAR",
    "DIR_VAR",
    "FSYNC_VAR",
    "SCHEMA_VERSION",
    "enabled",
    "enable",
    "disable",
    "journal_dir",
    "run_id",
    "record_event",
    "read_journal",
]

ENV_VAR = "PENCILARRAYS_TPU_OBS"
DIR_VAR = "PENCILARRAYS_TPU_OBS_DIR"
FSYNC_VAR = "PENCILARRAYS_TPU_OBS_FSYNC"
MAX_MB_VAR = "PENCILARRAYS_TPU_OBS_MAX_MB"
DEFAULT_DIR = "pa_obs"
# the JAX package's journal schema version: both packages write and
# lint the same record shapes (obs/schema.py)
SCHEMA_VERSION = 8

# events whose loss would blind a post-mortem: fsync'd under the default
# "critical" policy.  High-rate events (per-hop dispatch) only flush.
CRITICAL_EVENTS = frozenset({
    "run.start", "ckpt.save", "ckpt.commit", "ckpt.restore", "ckpt.verify",
    "fault", "retry", "dist.init",
    "guard.sdc", "guard.hang", "guard.recover", "guard.bundle",
    # mesh recovery coordination: each of these gates (or attributes) a
    # recovery decision, and the writer may be about to die — the
    # verdict/lease/epoch timeline is exactly what the post-mortem
    # aligns ranks by (lease events are journaled only on state
    # CHANGES — acquire/expiry — never per renewal, and routine `ok`
    # verdicts opt OUT per record via record_event's _fsync override,
    # so criticality never rides the healthy per-step path)
    "guard.epoch", "cluster.lease", "cluster.verdict",
    # elastic reformation: every stage record gates (or attributes) a
    # membership decision, and mid-reform is exactly when writers die
    "cluster.reform", "cluster.member",
    # the partition-tolerance plane: a quorum verdict gates
    # whether a whole side of a partition lives or exits, a rejected
    # zombie write is the proof the fence worked, and a WAL replay
    # summary is the restarted router's reconciliation record — each
    # is written exactly when its writer is most likely to die next
    "cluster.quorum", "cluster.fence", "fleet.wal",
    # a flagged straggler gates a scheduling/ops decision and the
    # flagging rank may be about to act on it
    "cluster.straggler",
    # the overload-survival plane: an SLO breach, a shedding-gate
    # transition and a scale decision each gate client-visible
    # behavior (failures, capacity moves) — the record must survive
    # the crash that often follows the overload that caused it
    "serve.slo_violation", "serve.pressure", "serve.scale",
    # an error-budget burn alert gates paging/shedding policy, and it
    # fires exactly when the process is most likely to die of the
    # overload that tripped it — the record must outlive the crash
    "serve.burn_alert",
    # a precision downgrade changes the answer a client receives — the
    # record of what envelope it was served under must survive the
    # overload that caused it (same plane as shed/burn above)
    "serve.precision",
    # fleet federation: a whole-mesh failover gates every re-bound
    # ticket, and a supervisor scale action moves real capacity —
    # both must survive the crash cascade that usually surrounds
    # them.  fleet.lease expiry (not routine acquire) and fleet.scale
    # dry-run signals opt in/out per record via the _fsync override;
    # fleet.route is high-rate and only flushes.
    "fleet.failover",
})

_lock = threading.Lock()
_override: Optional[bool] = None     # programmatic enable()/disable()
_override_dir: Optional[str] = None
_run_id: Optional[str] = None
_file = None
_file_dir: Optional[str] = None
_file_proc: Optional[int] = None
_seq = 0


def enabled() -> bool:
    """THE gate every instrumented call site probes first.  One branch +
    one cached snapshot probe on the disabled path — payloads are never
    built unless this returns True.  The env value rides the engine's
    shared :class:`~pencilarrays_tpu_torch.engine.config.RuntimeConfig`
    snapshot, which re-resolves on change (workers arm late, like
    faults)."""
    if _override is not None:
        return _override
    from ..engine import config as _rtc

    return _rtc.current().obs_on


def enable(directory: Optional[str] = None) -> None:
    """Programmatic enable (overrides the environment until
    :func:`disable`); ``directory`` overrides the journal location.
    Starts a fresh observability run: a new run id, and per-run dedup
    state (e.g. the planner's one-verdict-per-config journal filter)
    starts over."""
    global _override, _override_dir, _run_id
    with _lock:
        _close_locked()
        _override = True
        _override_dir = os.fspath(directory) if directory else None
        _run_id = None  # a fresh run id per enable (docstring contract)


def disable() -> None:
    """Programmatic disable: closes the journal and wins over the
    environment until the next :func:`enable`."""
    global _override, _override_dir
    with _lock:
        _close_locked()
        _override = False
        _override_dir = None


def _reset_for_tests() -> None:
    """Full reset: drop overrides AND the shared config snapshot (tests
    toggle the env between cases; production code never needs this)."""
    global _override, _override_dir, _run_id, _seq
    with _lock:
        _close_locked()
        _override = None
        _override_dir = None
        _run_id = None
        _seq = 0
    from ..engine import config as _rtc
    from . import correlate, requestflow

    _rtc._reset_for_tests()
    correlate._reset_for_tests()
    requestflow._reset_for_tests()


def journal_dir() -> str:
    """Resolved journal directory for the current configuration (knob
    parsing lives in ``engine/config.py``: a non-``1``/``on`` gate
    value is itself the directory)."""
    if _override_dir:
        return _override_dir
    from ..engine import config as _rtc

    cfg = _rtc.current()
    if cfg.obs_env not in ("", "0", "1", "on", "true", "off", "false"):
        return cfg.obs_env
    return cfg.obs_dir_env


def run_id() -> str:
    """Stable id of this process's observability run (new per enable)."""
    global _run_id
    if _run_id is None:
        _run_id = f"{os.getpid():x}-{uuid.uuid4().hex[:8]}"
    return _run_id


def _process_index() -> int:
    """Best-effort process index (``cluster.rank``: the rank override,
    else the process group's rank, else 0); never initializes anything,
    and the journal filename re-resolves when it changes."""
    try:
        from ..cluster import rank

        return rank()
    except Exception:
        return 0


def _close_locked() -> None:
    global _file, _file_dir, _file_proc
    if _file is not None:
        try:
            _file.close()
        except OSError:
            pass
    _file = None
    _file_dir = None
    _file_proc = None


def _open_locked(proc: Optional[int] = None):
    """(Re)open the journal for the resolved directory; emits the
    ``run.start`` boundary record on a fresh open.  The filename is
    re-resolved when the process index CHANGES — events recorded before
    the process group exists (e.g. ``dist.init connecting``) land in
    ``journal.r0.jsonl`` on every process, but the first post-connect
    record moves each process to its own ``journal.r<p>.jsonl`` (shared
    filesystems make cross-host O_APPEND to one file unreliable)."""
    global _file, _file_dir, _file_proc
    d = journal_dir()
    if proc is None:
        proc = _process_index()
    if _file is not None and _file_dir == d and _file_proc == proc:
        return _file
    _close_locked()
    os.makedirs(d, exist_ok=True)
    fsync_dir(d)
    path = os.path.join(d, f"journal.r{proc}.jsonl")
    # O_APPEND: whole-line atomicity for concurrent small appends
    _file = open(path, "a", buffering=1)
    _file_dir = d
    _file_proc = proc
    _write_locked("run.start", {
        "pid": os.getpid(),
        "argv": list(sys.argv[:4]),
    }, proc=proc)
    return _file


def _atexit_flush() -> None:
    """Normal-exit epilogue: publish the metrics snapshot next to the
    journal (a SIGKILL skips this by design — the journal itself is the
    crash-safe artifact).  Registered at import so metrics-only runs
    (counters/gauges bumped, no journal event ever recorded) still get
    their snapshot; a no-op while observability is off."""
    try:
        if enabled():
            from .metrics import write_snapshot

            record_event("run.stop")
            write_snapshot()
    except Exception:
        pass


atexit.register(_atexit_flush)


@contextmanager
def _forced(mode: str, directory: Optional[str] = None):
    """Temporarily force the gate — ``"on"`` (journal to ``directory``)
    or ``"unset"`` (override cleared AND env var removed: the true
    shipped-default path) — restoring EVERY piece of gate state after:
    override, env var, run id, and the journal fd (closed on exit, so a
    caller deleting ``directory`` afterwards leaks nothing).  The obs
    overhead bench arm uses this; keeping the surgery here keeps it
    next to the state it touches."""
    global _override, _override_dir, _run_id
    with _lock:
        saved = (_override, _override_dir, _run_id,
                 os.environ.get(ENV_VAR))
        _close_locked()
        if mode == "on":
            _override = True
            _override_dir = os.fspath(directory) if directory else None
        elif mode == "unset":
            _override = None
            _override_dir = None
            os.environ.pop(ENV_VAR, None)
        else:
            raise ValueError(f"unknown forced mode {mode!r}")
    try:
        yield
    finally:
        with _lock:
            _close_locked()
            _override, _override_dir, _run_id = saved[0], saved[1], saved[2]
            if saved[3] is None:
                os.environ.pop(ENV_VAR, None)
            else:
                os.environ[ENV_VAR] = saved[3]


def _json_safe(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _json_safe(x) for k, x in v.items()}
    try:
        import numpy as np

        if isinstance(v, np.integer):
            return int(v)
        if isinstance(v, np.floating):
            return float(v)
    except Exception:
        pass
    return str(v)


def _fsync_policy() -> str:
    from ..engine import config as _rtc

    return _rtc.current().obs_fsync      # PENCILARRAYS_TPU_OBS_FSYNC


def _max_bytes() -> Optional[int]:
    """Rotation cap from ``PENCILARRAYS_TPU_OBS_MAX_MB`` (None = never
    rotate; parsing lives in ``engine/config.py``)."""
    from ..engine import config as _rtc

    return _rtc.current().obs_max_bytes


def _rotate_locked() -> None:
    """Rotate the active journal to ``journal.r<p>.<k>.jsonl`` and
    reopen a fresh ``journal.r<p>.jsonl`` — always at a record boundary
    (called after a whole line landed), preserving the O_APPEND
    discipline on the new fd.  The per-process ``seq`` keeps counting
    across segments, so readers order a rank's records without caring
    which segment they came from.  No ``run.start`` is emitted: a
    rotation is mid-run, not a new run."""
    global _file
    d, proc = _file_dir, _file_proc
    base = os.path.join(d, f"journal.r{proc}.jsonl")
    try:
        _file.close()
    except OSError:
        pass
    _file = None
    k = 1
    while os.path.exists(os.path.join(d, f"journal.r{proc}.{k}.jsonl")):
        k += 1
    try:
        os.replace(base, os.path.join(d, f"journal.r{proc}.{k}.jsonl"))
        fsync_dir(d)
    except OSError:
        pass    # a failed rename just keeps appending to the old file
    _file = open(base, "a", buffering=1)


def _write_locked(ev: str, fields: dict, proc: Optional[int] = None,
                  fsync: Optional[bool] = None) -> None:
    global _seq
    from . import correlate, requestflow

    _seq += 1
    rec = {"v": SCHEMA_VERSION, "ev": ev, "run": run_id(),
           "proc": _process_index() if proc is None else proc,
           "seq": _seq,
           "t_wall": time.time(), "t_mono": time.monotonic()}
    for k, v in fields.items():
        if k not in rec:
            rec[k] = _json_safe(v)
    # correlation keys (step_idx / epoch / plan_fp) fill in AFTER the
    # payload: every record joins the cross-rank timeline, but an
    # emitter that passes one explicitly keeps its value — a
    # cluster.verdict journals the verdict's OWN epoch, not whatever
    # the global counter reads at write time (a concurrent advance
    # between payload construction and this lock must not rewrite it)
    for k, v in correlate.stamp().items():
        rec.setdefault(k, v)
    # the ambient request trace (obs/requestflow.py) folds in by the
    # same discipline: the serve/fleet emitters pass trace= explicitly
    # (their records are written from pump/engine threads with no
    # ambient context), and that explicit value always wins
    for k, v in requestflow.stamp().items():
        rec.setdefault(k, v)
    _file.write(json.dumps(rec, separators=(",", ":")) + "\n")
    _file.flush()
    policy = _fsync_policy()
    critical = ev in CRITICAL_EVENTS if fsync is None else fsync
    if policy == "always" or (policy == "critical" and critical):
        try:
            os.fsync(_file.fileno())
        except OSError:
            pass
    cap = _max_bytes()
    if cap is not None:
        try:
            if _file.tell() >= cap:
                _rotate_locked()
        except (OSError, ValueError):
            pass


def record_event(ev: str, _fsync: Optional[bool] = None, **fields) -> bool:
    """Append one record to the journal.  Returns False (doing NOTHING,
    allocating nothing beyond the kwargs dict) when observability is
    disabled — the contract that keeps instrumented hot paths free.

    ``_fsync`` overrides the event type's CRITICAL_EVENTS membership
    for THIS record (under the default ``critical`` policy) — for event
    types whose criticality depends on the payload, e.g. a
    ``cluster.verdict`` gates recovery only when its action is not
    ``ok``, and a routine ok verdict fires once per step boundary."""
    if not enabled():
        return False
    try:
        proc = _process_index()  # once per event, outside the lock
        with _lock:
            if not enabled():
                return False  # lost a race with disable(): a stale
                # thread must not resurrect the journal while off
            _open_locked(proc)
            _write_locked(ev, fields, proc=proc, fsync=_fsync)
        return True
    except OSError:
        return False  # a full/readonly disk must never take down the job


def read_journal(directory: Optional[str] = None) -> List[dict]:
    """Parse every ``journal.r*.jsonl`` under ``directory`` (default:
    the active journal dir) into one timeline ordered by wall time then
    per-process sequence.  Rotated segments (``journal.r<p>.<k>.jsonl``,
    see ``PENCILARRAYS_TPU_OBS_MAX_MB``) match the same glob and are
    read transparently.  Unparseable lines (a torn final line from a
    crash without O_APPEND atomicity, foreign garbage) are skipped — the
    reader is a forensic tool and must not die on wreckage."""
    import glob

    d = directory or journal_dir()
    events = []
    for path in sorted(glob.glob(os.path.join(d, "journal.r*.jsonl"))):
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    e = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if isinstance(e, dict):
                    events.append(e)
    events.sort(key=lambda e: (e.get("t_wall", 0.0), e.get("proc", 0),
                               e.get("seq", 0)))
    return events
