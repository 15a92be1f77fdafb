"""Crash-bundle writer — the post-mortem artifact of the guard (the JAX
package's ``guard/bundle.py``, the same layout and manifest).

A hang or a detected corruption must leave more than a stack trace in a
log scrollback: the **crash bundle** is one directory holding everything
a post-mortem needs, written best-effort (a failing artifact is recorded
in the manifest, never raised — the bundle writer must not take down the
error path it serves):

::

    <bundle_dir>/bundle-<utc>-p<pid>-<n>/
        MANIFEST.json    # reason, label, error, env snapshot, versions
                         # (python, torch, CUDA, numpy), per-artifact
                         # status (written LAST: its presence marks a
                         # complete bundle)
        stacks.txt       # per-thread Python stacks at capture time
        metrics.json     # obs metrics-registry snapshot
        plans.json       # recent plan fingerprints (FFT plan schedules,
                         # reshard routes) + schedule hashes
        journal/         # copy of the obs journal files (when obs is
                         # armed — the flight-recorder timeline)

Bundles are capped at :data:`MAX_BUNDLES` per process so a pathological
retry loop cannot fill the disk with near-identical post-mortems.
"""

from __future__ import annotations

import glob
import hashlib
import itertools
import json
import os
import shutil
import sys
import threading
import time
import traceback
from collections import deque
from typing import Optional

from ..resilience.fsutil import atomic_write_json, fsync_dir

__all__ = ["write_crash_bundle", "note_plan", "recent_plans", "MAX_BUNDLES"]

MAX_BUNDLES = 16

_counter = itertools.count(1)
_written = 0
_lock = threading.Lock()

# Recent plan fingerprints (FFT plan schedules, reshard routes): fed by
# the planners when the guard is armed, drained into every bundle so a
# post-mortem can tell which plans were in flight.
_PLANS: deque = deque(maxlen=32)
_PLAN_KEYS: set = set()


def _reset_for_tests() -> None:
    """Reset the per-process bundle cap (tests drill many detections in
    one process; production never needs this)."""
    global _written
    with _lock:
        _written = 0


def note_plan(kind: str, fingerprint: dict) -> None:
    """Register a plan fingerprint for future bundles (deduplicated per
    process on the fingerprint's schedule hash)."""
    try:
        blob = json.dumps(fingerprint, sort_keys=True, default=str)
    except Exception:
        blob = repr(fingerprint)
    digest = hashlib.sha256(blob.encode()).hexdigest()
    key = (kind, digest)
    with _lock:
        if key in _PLAN_KEYS:
            return
        if len(_PLANS) == _PLANS.maxlen:
            oldest = _PLANS[0]
            _PLAN_KEYS.discard((oldest["kind"], oldest["schedule_sha256"]))
        _PLAN_KEYS.add(key)
        _PLANS.append({"kind": kind, "t_wall": time.time(),
                       "schedule_sha256": digest, "plan": fingerprint})


def recent_plans() -> list:
    """The plan fingerprints a bundle written now would contain."""
    with _lock:
        return list(_PLANS)


def _thread_stacks() -> str:
    frames = sys._current_frames()
    names = {t.ident: t for t in threading.enumerate()}
    out = []
    for ident, frame in frames.items():
        t = names.get(ident)
        label = (f"{t.name} (daemon={t.daemon})" if t is not None
                 else "unknown")
        out.append(f"--- thread {ident} [{label}] ---")
        out.extend(line.rstrip()
                   for line in traceback.format_stack(frame))
        out.append("")
    return "\n".join(out)


def _env_snapshot() -> dict:
    # the package's knobs and this runtime's (the JAX package keeps its
    # JAX_/XLA_/TPU_ ones)
    keep_prefixes = ("PENCILARRAYS_TPU_", "TORCH_", "CUDA_", "NCCL_",
                     "PYTORCH_")
    return {k: v for k, v in sorted(os.environ.items())
            if k.startswith(keep_prefixes)}


def _versions() -> dict:
    """The runtime's versions: python, torch, the CUDA torch was built
    for (None in a CPU build), numpy.  Nothing here initializes CUDA."""
    out = {"python": sys.version.split()[0]}
    for mod in ("torch", "numpy"):
        try:
            out[mod] = __import__(mod).__version__
        except Exception:
            out[mod] = None
    try:
        import torch

        out["cuda"] = torch.version.cuda
    except Exception:
        out["cuda"] = None
    return out


def write_crash_bundle(reason: str, label: str, *,
                       error: Optional[str] = None,
                       extra: Optional[dict] = None) -> Optional[str]:
    """Write one crash bundle; returns its directory (None when the
    per-process cap is reached or the directory itself is unwritable).
    Never raises: each artifact is best-effort and failures are recorded
    in the manifest's ``artifacts`` map."""
    global _written
    from . import bundle_dir

    with _lock:
        if _written >= MAX_BUNDLES:
            return None
        _written += 1
    root = bundle_dir()
    name = (f"bundle-{time.strftime('%Y%m%dT%H%M%S', time.gmtime())}"
            f"-p{os.getpid()}-{next(_counter)}")
    path = os.path.join(root, name)
    try:
        os.makedirs(path, exist_ok=True)
    except OSError:
        return None

    artifacts = {}

    def _try(name_, fn):
        try:
            fn()
            # an artifact body may have recorded its own status
            # (e.g. journal: "skipped: obs disabled") — keep it
            artifacts.setdefault(name_, "ok")
        except Exception as e:  # pragma: no cover - defensive
            artifacts[name_] = f"failed: {type(e).__name__}: {e}"

    def _stacks():
        with open(os.path.join(path, "stacks.txt"), "w") as f:
            f.write(_thread_stacks())

    def _metrics():
        from ..obs import snapshot

        atomic_write_json(os.path.join(path, "metrics.json"), snapshot())

    def _plans():
        atomic_write_json(os.path.join(path, "plans.json"), recent_plans())

    def _journal():
        from ..obs import enabled as obs_enabled, journal_dir

        if not obs_enabled():
            artifacts["journal"] = "skipped: obs disabled"
            return
        src = journal_dir()
        dst = os.path.join(path, "journal")
        os.makedirs(dst, exist_ok=True)
        for p in sorted(glob.glob(os.path.join(src, "journal.r*.jsonl"))):
            shutil.copy2(p, dst)

    _try("stacks", _stacks)
    _try("metrics", _metrics)
    _try("plans", _plans)
    _try("journal", _journal)

    try:
        from ..cluster import epoch as _epoch

        epoch = _epoch.current()
    except Exception:   # pragma: no cover - the stamp is best-effort
        epoch = None
    manifest = {
        "format": "pencilarrays-tpu-crash-bundle",
        "version": 1,
        "reason": reason,
        "label": label,
        "error": error,
        # recovery-epoch stamp: aligns this bundle with the mesh's
        # verdict/journal timelines
        "epoch": epoch,
        "pid": os.getpid(),
        "t_wall": time.time(),
        "argv": list(sys.argv[:6]),
        "env": _env_snapshot(),
        "versions": _versions(),
        "artifacts": artifacts,
        # post-mortem entry point: the bundled journal copy is a
        # self-contained obs directory — one command reconstructs the
        # merged cross-rank timeline from exactly what this bundle saw
        "timeline_cmd": (
            "python -m pencilarrays_tpu_torch.obs timeline "
            + os.path.join(path, "journal")
            if artifacts.get("journal") == "ok" else None),
        **(extra or {}),
    }
    try:
        # last artifact written: a MANIFEST.json marks a complete bundle
        atomic_write_json(os.path.join(path, "MANIFEST.json"), manifest)
        fsync_dir(path)
    except OSError:
        return None

    from ..obs import counter, enabled as obs_enabled, record_event

    if obs_enabled():
        counter("guard.bundles", reason=reason).inc()
        record_event("guard.bundle", path=path, reason=reason, label=label)
    return path
